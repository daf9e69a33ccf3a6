// The SAM two-way transformer's two cross attentions over the per-prompt
// image keys (B, N, C), each one pass over the keys:
//
// - t2i_stream_kernel (token -> image; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:t2i_stream): per key tile,
//   kp = x @ Wk^T + pe_wk + bk and vp = x @ Wv^T + bv, then an online
//   softmax over the image axis for every (token, head) row of the prompt's
//   pre-scaled queries. Writes only the (B, T, I) head-merged output.
// - i2t_block_kernel (image -> token; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:i2t_block_step): per strip of
//   image rows, qp = x @ Wq^T + pe_wq + bq, attention over the prompt's T
//   tokens per head, out-projection, residual and the block's LayerNorm.
//   Reads keys once and writes the updated keys once.
//
// Bound on the card, SAM's decoder (C 256, I 128, 8 heads of 16, T tokens:
// 7 for a one-point prompt), a chunk of B = 256 prompts over N = 4096
// image tokens: each kernel does 2*B*N*C*I*2 = 137 GFLOP of projections
// (0.14 ms on the tensor cores) against 537 MB (t2i: one read) or 1.07 GB
// (i2t: read + write, 0.32 ms) of keys; the attention itself (T = 7 tokens)
// is 1/16 of that. So i2t is bound by its bytes; with batch-1 keys (the
// decoder's block 0: every prompt shares the image embedding) by writing
// its (B, N, C) output, 0.16 ms.
//
// t2i (any T >= 1: a click loop's 20 points make 26 tokens) keeps the
// online-softmax state of up to kTT 16-row token tiles in registers and
// loops over them after each key tile's projection; a prompt of more tiles
// takes more blocks (grid.y), each projecting the keys again. The TPU
// kernels packed the 8 heads block-diagonally ((head, token) rows against
// 128-wide columns) so that the MXU saw dense 128-lane matmuls. On the card
// a head is a 16-wide slice: t2i gives each warp one head, and its scores
// Q_h (16 padded token rows x 16) @ Kp_h^T are one 16x16x16 mma per 16
// keys. Its projection weights (128 KB) stay in shared memory for the whole
// block, the key tiles stream through a two-slot cp.async ring, and rows
// are padded by 16 bytes so that fragment loads do not conflict on banks.
// In its projection epilogue a lane owns 8 contiguous columns: its bias and
// PE values come as 16-byte loads issued ahead of the products, its results
// go out as 16-byte stores. With batch-1 keys t2i recomputes the k/v
// projection per prompt (one block per prompt), which costs what a
// per-prompt call costs.
//
// i2t (1 <= T <= 64) runs one persistent block an SM that stages Wq and Wo
// (137 KB) once and walks a contiguous range of (row group, prompt) work
// items; each warp owns a 16-row strip of the group, and the strips stream
// through one cp.async slot a warp (the next strip's load issued as soon as
// the strip is read out, the other warps' products covering it). A warp
// keeps the whole step in registers with mma.sync m16n8k16 (mma.cuh): qp
// (16 x 128, fp32 sums, rounded there and packed into the A fragments of
// the 8 heads), the scores of each head against the prompt's tokens (fp32,
// masked past T), the softmax (expf, p normalised, rounded to bf16 as the A
// operand of p v), the head outputs (the A fragments of the out-projection)
// and the out-projection in four quarters of 64 columns; the residual rows
// go to the strip's slot in bf16 (the values the LayerNorm reads), and the
// LayerNorm writes each output row once in 16-byte stores. A prompt's k and
// v (T padded to 16 rows, the rest zero) sit in shared memory in a ring of
// two stages for T <= 16 (the next prompt's fetched while this one's run),
// one above; the block turns the ring over when its prompt changes
// (work items are prompt-major, so once a prompt's groups are done). With
// batch-1 keys the items are group-major instead: a strip's qp is computed
// once and kept in registers for the prompts that follow, Wq is staged only
// for that, and its region holds the warps' residual rows meanwhile, so the
// x strips stay put across the prompts.
//
// Rounding points follow the TPU kernels: products accumulate in fp32 and
// are rounded to bf16, then each bias or PE term is added and rounded in
// turn; scores and softmax in fp32; probabilities rounded to bf16 before
// p @ v; the online softmax rounds the unnormalised p (as t2i_stream);
// LayerNorm in fp32 with the two-pass variance.
#include "mma.cuh"

namespace iuvl {
namespace {

constexpr int kC = 256;      // embedding width
constexpr int kI = 128;      // attention width (C / 2)
constexpr int kHd = 16;      // head dim (8 heads)
constexpr int kTok = 16;     // t2i: tokens a tile
constexpr int kTT = 2;       // t2i: token tiles a block
constexpr int kLdC = kC + 8; // padded bf16 rows of C columns
constexpr int kLdI = kI + 8; // padded bf16 rows of I columns
static_assert(kI / kHd == kWarps, "t2i gives each warp one head");

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) into shared memory with
// row stride `ld`, by cp.async in 16-byte pieces.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t src_ld,
                                           int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, v = i % vec;
    cp_async16(dst + r * ld + v * 8, src + r * src_ld + v * 8);
  }
}

// 8 bf16 values in one 16-byte register group.
__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ float at8(const uint4& v, int j) {
  return to_f(reinterpret_cast<const bf16*>(&v)[j]);
}

// ---------------------------------------------------------------- t2i --
constexpr int kKT = 32;        // keys per tile
constexpr int kLdS = kKT + 4;  // fp32 scores
constexpr int kLdP = kKT + 8;  // bf16 probabilities

struct T2iSmem {
  static constexpr size_t kW = 2 * kI * kLdC * sizeof(bf16);  // Wk rows, then Wv rows
  static constexpr size_t kX = kKT * kLdC * sizeof(bf16);     // one key tile
  static constexpr size_t kKV = kKT * kLdI * sizeof(bf16);    // kp or vp of a tile
  static constexpr size_t kQ = kTT * kTok * kLdI * sizeof(bf16);
  static constexpr size_t kS = kWarps * kTok * kLdS * sizeof(float);
  static constexpr size_t kP = kWarps * kTok * kLdP * sizeof(bf16);
  static constexpr size_t kBytes = kW + 2 * kX + 2 * kKV + kQ + kS + kP;
};

__global__ void __launch_bounds__(kThreads) t2i_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ keys, const bf16* __restrict__ pe_wk,
    const bf16* __restrict__ wk, const bf16* __restrict__ bk, const bf16* __restrict__ wv,
    const bf16* __restrict__ bv, bf16* __restrict__ out, int n, int tokens, int shared_keys) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sX = sW + 2 * kI * kLdC;  // two slots
  bf16* sK = sX + 2 * kKT * kLdC;
  bf16* sV = sK + kKT * kLdI;
  bf16* sQ = sV + kKT * kLdI;
  float* sS = reinterpret_cast<float*>(sQ + kTT * kTok * kLdI);
  bf16* sP = reinterpret_cast<bf16*>(sS + kWarps * kTok * kLdS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int tok0 = blockIdx.y * kTT * kTok;  // this block's first token
  const int ntt = min(kTT, (tokens - tok0 + kTok - 1) / kTok);  // its token tiles
  const bf16* xb = keys + (shared_keys ? size_t{0} : static_cast<size_t>(b) * n * kC);
  const int tiles = n / kKT;

  stage_rows(sW, kLdC, wk, kC, kI, kC);
  stage_rows(sW + kI * kLdC, kLdC, wv, kC, kI, kC);
  stage_rows(sX, kLdC, xb, kC, kKT, kC);
  cp_async_commit();
  for (int i = tid; i < kTT * kTok * kI; i += kThreads) {
    const int r = i / kI, c = i % kI, tok = tok0 + r;
    sQ[r * kLdI + c] =
        tok < tokens ? q[(static_cast<size_t>(b) * tokens + tok) * kI + c] : to_bf(0.f);
  }

  // Warp `warp` is head `warp`; lane owns token row `row` of each of the
  // block's token tiles, keys [half*16, half*16+16) of each key tile and
  // output columns [half*8, half*8+8).
  const int row = lane >> 1, half = lane & 1;
  float m[kTT], l[kTT], acc[kTT][8];
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) {
    m[tt] = kNegInf;
    l[tt] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[tt][j] = 0.f;
  }
  float* S = sS + warp * kTok * kLdS;  // also the warp's 16x16 staging tile
  bf16* P = sP + warp * kTok * kLdP;
  // Projection tiles of this warp: row tile prt, column tiles pct..pct+3 of
  // [kp | vp] (256 columns: warps 0-3 make kp, 4-7 vp). In the epilogue a
  // lane owns row er and columns ec..ec+7 of each 16x16 tile, so its bias
  // values are fixed (registers, loaded once) and its PE values are one
  // 16-byte load per tile, issued before the tile's products.
  const int prt = warp & 1, pct = (warp >> 1) * 4;
  const bool is_k = pct * 16 < kI;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  uint4 bias[4], pe[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = (pct + u) * 16 + ec;
    bias[u] = is_k ? load8(bk + c) : load8(bv + c - kI);
  }

  for (int kt = 0; kt < tiles; ++kt) {
    // The slot of tile kt + 1 held tile kt - 1, whose last reads precede
    // the barrier after its projection.
    if (kt + 1 < tiles)
      stage_rows(sX + ((kt + 1) & 1) * kKT * kLdC, kLdC,
                 xb + static_cast<size_t>(kt + 1) * kKT * kC, kC, kKT, kC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* X = sX + (kt & 1) * kKT * kLdC;
    if (is_k) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pe[u] = load8(pe_wk + (static_cast<size_t>(kt) * kKT + prt * 16 + er) * kI +
                      (pct + u) * 16 + ec);
    }

    FragC pc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wmma::fill_fragment(pc[u], 0.f);
#pragma unroll 4
    for (int kk = 0; kk < kC; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, X + prt * 16 * kLdC + kk, kLdC);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        FragBc fb;  // B[k][n] = W[(pct+u)*16 + n][kk + k]
        wmma::load_matrix_sync(fb, sW + (pct + u) * 16 * kLdC + kk, kLdC);
        wmma::mma_sync(pc[u], fa, fb, pc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wmma::store_matrix_sync(S, pc[u], 16, wmma::mem_row_major);
      __syncwarp();
      uint4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y = round_bf(S[er * 16 + ec + j]);
        if (is_k) y = round_bf(y + at8(pe[u], j));
        o[j] = to_bf(y + at8(bias[u], j));
      }
      const int r = prt * 16 + er, c = (pct + u) * 16 + ec;
      *reinterpret_cast<uint4*>(is_k ? sK + r * kLdI + c : sV + r * kLdI + c - kI) = packed;
      __syncwarp();
    }
    __syncthreads();

#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {
      if (tt >= ntt) break;
      // Scores of head `warp`: token tile tt's 16 rows x 32 keys.
      FragA qa;
      wmma::load_matrix_sync(qa, sQ + tt * kTok * kLdI + warp * kHd, kLdI);
#pragma unroll
      for (int u = 0; u < kKT / 16; ++u) {
        FragC sc;
        wmma::fill_fragment(sc, 0.f);
        FragBc kb;  // B[k][n] = Kp[u*16 + n][warp*16 + k]
        wmma::load_matrix_sync(kb, sK + u * 16 * kLdI + warp * kHd, kLdI);
        wmma::mma_sync(sc, qa, kb, sc);
        wmma::store_matrix_sync(S + u * 16, sc, kLdS, wmma::mem_row_major);
      }
      __syncwarp();
      float s[16], mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[j] = S[row * kLdS + half * 16 + j];
        mc = fmaxf(mc, s[j]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      const float m_new = fmaxf(m[tt], mc);
      const float alpha = expf(m[tt] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p = expf(s[j] - m_new);
        ps += p;
        P[row * kLdP + half * 16 + j] = to_bf(p);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      l[tt] = alpha * l[tt] + ps;
      m[tt] = m_new;
      __syncwarp();

      FragC oc;
      wmma::fill_fragment(oc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kKT; kk += 16) {
        FragA pa;
        wmma::load_matrix_sync(pa, P + kk, kLdP);
        FragBr vb;  // B[k][n] = Vp[kk + k][warp*16 + n]
        wmma::load_matrix_sync(vb, sV + kk * kLdI + warp * kHd, kLdI);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(S, oc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[tt][j] = acc[tt][j] * alpha + S[row * 16 + half * 8 + j];
      __syncwarp();  // S and P are read before the next token tile writes them
    }
    __syncthreads();  // sK, sV and the slot of tile kt are free
  }

#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) {
    const int tok = tok0 + tt * kTok + row;
    if (tt >= ntt || tok >= tokens) break;
    const float lf = fmaxf(l[tt], 1e-30f);
    bf16* o = out + (static_cast<size_t>(b) * tokens + tok) * kI + warp * kHd + half * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = to_bf(acc[tt][j] / lf);
  }
}

// ---------------------------------------------------------------- i2t --
// Persistent blocks of nw warps (8, or 7 for T > 48: shared memory), one
// block an SM. Shared memory: region A (Wq, or with batch-1 keys the
// warps' y strips), Wo, bq and bo, the token k / v ring (two stages of T
// padded to 16 rows for T <= 16, else one) and one 16-row x strip a warp.
constexpr int kMaxTok = 64;                              // tokens the kernel holds
constexpr int kStrip = 16;                               // image rows a warp's strip
constexpr size_t kRegionA = size_t{kI} * kLdC * 2;       // Wq; batch-1: y strips
constexpr size_t kRegionB = size_t{kC} * kLdI * 2;       // Wo
constexpr size_t kParams = (kI + kC) * 2;                // bq, bo
constexpr size_t kSlot = size_t{kStrip} * kLdC * 2;      // a warp's x strip
static_assert(kWarps * kSlot <= kRegionA, "batch-1 y strips fit region A");

__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
// bf16(bf16(bf16(a, b) + c) + d) for a pair: a product's two sums rounded
// to bf16, then two terms added and rounded in turn (the TPU rounding).
__device__ __forceinline__ uint32_t add2_round(float a, float b, uint32_t c, uint32_t d) {
  return u32(__hadd2(__hadd2(__floats2bfloat162_rn(a, b), bf2(c)), bf2(d)));
}

// qa[h] = the A fragments of qp = bf16(bf16(bf16(x Wq^T) + pe) + bq) for
// head h of the warp's 16 rows (x: the strip in shared memory; pe: the
// strip's first row of pe_wq). Products in fp32 registers, rounded there.
__device__ __forceinline__ void i2t_qp(uint32_t (&qa)[8][4], const bf16* X, const bf16* sWq,
                                       const bf16* pe, const bf16* sbq) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q2 = 2 * (lane & 3);
  uint32_t pe_lo[16], pe_hi[16];  // issued ahead of the products
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pe_lo[j] = __ldg(reinterpret_cast<const unsigned*>(pe + g * kI + 8 * j + q2));
    pe_hi[j] = __ldg(reinterpret_cast<const unsigned*>(pe + (g + 8) * kI + 8 * j + q2));
  }
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < kC / 16; ++kk) {
    uint32_t a[4];
    lda_rows(a, X, kLdC, 0, kk * 16);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t b[4];
      ldb_rows(b, sWq, kLdC, np * 16, kk * 16);  // B[k][n] = Wq[n][k]
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = 2 * h + u;
      const uint32_t bq2 = *reinterpret_cast<const uint32_t*>(sbq + 8 * j + q2);
      qa[h][2 * u] = add2_round(acc[j][0], acc[j][1], pe_lo[j], bq2);
      qa[h][2 * u + 1] = add2_round(acc[j][2], acc[j][3], pe_hi[j], bq2);
    }
}

// att[h] = the A fragments of bf16(softmax(qp_h kp_h^T * scale) v_h) over
// the prompt's T tokens (NP pairs of 8-token tiles, the tokens past T
// masked; kp, vp in shared memory, the rows past T zero): scores, softmax
// (fp32, expf, p normalised and rounded to bf16) and p v in registers.
template <int NP>
__device__ __forceinline__ void i2t_attend(uint32_t (&att)[8][4], const uint32_t (&qa)[8][4],
                                           const bf16* sKp, const bf16* sVp, int tokens,
                                           float scale) {
  const int lane = threadIdx.x & 31, q2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float s[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t b[4];
      ldb_rows(b, sKp, kLdI, p * 16, h * 16);  // B[k][t] = kp[t][16 h + k]
      mma16816(s[2 * p], qa[h], b[0], b[1]);
      mma16816(s[2 * p + 1], qa[h], b[2], b[3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // the lane's rows g (u = 0) and g + 8
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) {
          const float v = 8 * j + q2 + (e & 1) < tokens ? s[j][e] * scale : kNegInf;
          s[j][e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
        if (8 * j >= tokens) {  // a tile wholly past T: p = 0
          s[j][2 * u] = s[j][2 * u + 1] = 0.f;
          continue;
        }
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          den += s[j][e];
        }
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const float inv = 1.f / den;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) s[j][e] *= inv;
    }
    float o[2][4] = {};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t a[4], b[4];
      acc_to_a(a, s[2 * p], s[2 * p + 1]);      // p rounded to bf16
      ldb_cols(b, sVp, kLdI, h * 16, p * 16);  // B[t][c] = vp[t][16 h + c]
      mma16816(o[0], a, b[0], b[1]);
      mma16816(o[1], a, b[2], b[3]);
    }
    acc_to_a(att[h], o[0], o[1]);
  }
}

// Y = bf16(X + bf16(bf16(att Wo^T) + bo)) for the warp's 16 rows, in four
// quarters of 64 columns (fp32 sums in registers), written to the y strip
// in shared memory (X's own place with per-prompt keys: each lane writes
// the elements it read).
__device__ __forceinline__ void i2t_out(const uint32_t (&att)[8][4], const bf16* X, bf16* Y,
                                        const bf16* sWo, const bf16* sbo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll 1
  for (int c0 = 0; c0 < kC; c0 += 64) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldb_rows(b, sWo, kLdI, c0 + np * 16, h * 16);  // B[k][n] = Wo[n][k]
        mma16816(acc[2 * np], att[h], b[0], b[1]);
        mma16816(acc[2 * np + 1], att[h], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + q2;
      const uint32_t bo2 = *reinterpret_cast<const uint32_t*>(sbo + c);
      const uint32_t x_lo = *reinterpret_cast<const uint32_t*>(X + g * kLdC + c);
      const uint32_t x_hi = *reinterpret_cast<const uint32_t*>(X + (g + 8) * kLdC + c);
      *reinterpret_cast<uint32_t*>(Y + g * kLdC + c) =
          u32(__hadd2(bf2(x_lo), __hadd2(__floats2bfloat162_rn(acc[j][0], acc[j][1]), bf2(bo2))));
      *reinterpret_cast<uint32_t*>(Y + (g + 8) * kLdC + c) =
          u32(__hadd2(bf2(x_hi), __hadd2(__floats2bfloat162_rn(acc[j][2], acc[j][3]), bf2(bo2))));
    }
  }
}

// LayerNorm (fp32, two-pass variance) of the y strip's 16 rows into out
// (the strip's first output row): two rows at a time, 16 lanes a row, a
// lane 8 columns in each half; each row written once, in 16-byte stores.
__device__ __forceinline__ void i2t_norm(bf16* out, const bf16* Y, const float* ln_w,
                                         const float* ln_b, float eps) {
  const int lane = threadIdx.x & 31, c = 8 * (lane & 15);
  float w[16], bias[16];  // the lane's columns' LayerNorm parameters
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = (k >> 1) * 128 + c + 4 * (k & 1);
    const float4 wv = __ldg(reinterpret_cast<const float4*>(ln_w + at));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(ln_b + at));
    w[4 * k] = wv.x, w[4 * k + 1] = wv.y, w[4 * k + 2] = wv.z, w[4 * k + 3] = wv.w;
    bias[4 * k] = bv.x, bias[4 * k + 1] = bv.y, bias[4 * k + 2] = bv.z, bias[4 * k + 3] = bv.w;
  }
#pragma unroll 4
  for (int r = lane >> 4; r < kStrip; r += 2) {
    float v[16];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint4 raw = *reinterpret_cast<const uint4*>(Y + r * kLdC + hf * 128 + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[8 * hf + j] = at8(raw, j);
    }
    float mean = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) mean += v[j];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mean += __shfl_xor_sync(0xffffffffu, mean, o);
    mean /= kC;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) sq += (v[j] - mean) * (v[j] - mean);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / kC + eps);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint4 packed;
      bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * hf + j;
        ov[j] = to_bf((v[k] - mean) * rstd * w[k] + bias[k]);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * kC + hf * 128 + c) = packed;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) i2t_block_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ pe_wq, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const bf16* __restrict__ wq, const bf16* __restrict__ bq,
    const bf16* __restrict__ wo, const bf16* __restrict__ bo, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bf16* __restrict__ out, int batch, int n, int tokens,
    int shared_keys, float scale, float eps, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tpad = (tokens + 15) / 16 * 16, np = tpad / 16;
  bf16* sA = reinterpret_cast<bf16*>(smem);  // Wq, or batch-1's y strips
  bf16* sWo = sA + kI * kLdC;
  bf16* sbq = sWo + kC * kLdI;
  bf16* sbo = sbq + kI;
  bf16* sKV = sbo + kC;  // stage s: kp rows, then vp rows (tpad each)
  bf16* X = sKV + stages * 2 * tpad * kLdI + warp * kStrip * kLdC;
  bf16* Y = shared_keys ? sA + warp * kStrip * kLdC : X;

  // Work items (row group g of nw strips, prompt p), a contiguous range a
  // block: prompt-major with per-prompt keys (the token ring turns over
  // once a prompt's groups are done), group-major with batch-1 keys (qp of
  // a strip is computed once for the prompts that follow).
  const int strips = n / kStrip, groups = (strips + nw - 1) / nw;
  const int total = batch * groups;
  const int i0 = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
  auto prompt_of = [&](int i) { return shared_keys ? i % batch : i / groups; };
  auto group_of = [&](int i) { return shared_keys ? i / batch : i % groups; };
  // The first item past i with another prompt (i1 if none).
  auto next_prompt = [&](int i) {
    return shared_keys ? i + 1 : min(i1, (i / groups + 1) * groups);
  };
  auto stage_kv = [&](int slot, int p) {  // rows past T are zero-filled
    bf16* d = sKV + slot * 2 * tpad * kLdI;
    const size_t g0 = static_cast<size_t>(p) * tokens * kI;
    cp_rows<kI>(d, kLdI, kp + g0, 0, tpad, tokens, tid, nt);
    cp_rows<kI>(d + tpad * kLdI, kLdI, vp + g0, 0, tpad, tokens, tid, nt);
  };
  auto stage_x = [&](int i) {  // the warp's strip of item i, if it has one
    const int s = group_of(i) * nw + warp;
    const size_t row0 = static_cast<size_t>(shared_keys ? 0 : prompt_of(i)) * n + s * kStrip;
    if (s < strips) cp_rows<kC>(X, kLdC, keys + row0 * kC, 0, kStrip, kStrip, lane, 32);
  };
  if (i0 >= i1) return;

  if (!shared_keys) cp_rows<kC>(sA, kLdC, wq, 0, kI, kI, tid, nt);
  cp_rows<kI>(sWo, kLdI, wo, 0, kC, kC, tid, nt);
  cp_rows<kI>(sbq, kI, bq, 0, 1, 1, tid, nt);
  cp_rows<kC>(sbo, kC, bo, 0, 1, 1, tid, nt);
  int slot = 0, cur_p = prompt_of(i0);
  stage_kv(0, cur_p);
  if (!shared_keys) stage_x(i0);
  cp_async_commit();
  if (stages == 2 && next_prompt(i0) < i1) {
    stage_kv(1, prompt_of(next_prompt(i0)));
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[8][4], att[8][4];
  int cur_g = -1;
  for (int i = i0; i < i1; ++i) {
    const int p = prompt_of(i), g = group_of(i), s = g * nw + warp;
    cp_async_wait<0>();  // this item's x strip; a prefetched token stage
    if (p != cur_p) {  // the token ring turns over (block-uniform)
      if (stages == 2) {
        __syncthreads();  // the prefetched stage has landed everywhere; the old one is free
        slot ^= 1;
        if (next_prompt(i) < i1) {
          stage_kv(slot ^ 1, prompt_of(next_prompt(i)));
          cp_async_commit();
        }
      } else {
        __syncthreads();  // every warp is done with the one stage
        stage_kv(0, p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      cur_p = p;
    }
    if (shared_keys && g != cur_g) {  // batch-1 keys: a new group's x and qp
      __syncthreads();  // region A's y strips are read out
      cp_rows<kC>(sA, kLdC, wq, 0, kI, kI, tid, nt);
      stage_x(i);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (s < strips) i2t_qp(qa, X, sA, pe_wq + static_cast<size_t>(s) * kStrip * kI, sbq);
      __syncthreads();  // Wq is read out: region A holds y strips again
      cur_g = g;
    }
    __syncwarp();
    if (s < strips) {
      const bf16* sKp = sKV + slot * 2 * tpad * kLdI;
      const bf16* sVp = sKp + tpad * kLdI;
      if (!shared_keys) i2t_qp(qa, X, sA, pe_wq + static_cast<size_t>(s) * kStrip * kI, sbq);
      switch (np) {
        case 1: i2t_attend<1>(att, qa, sKp, sVp, tokens, scale); break;
        case 2: i2t_attend<2>(att, qa, sKp, sVp, tokens, scale); break;
        case 3: i2t_attend<3>(att, qa, sKp, sVp, tokens, scale); break;
        default: i2t_attend<4>(att, qa, sKp, sVp, tokens, scale); break;
      }
      i2t_out(att, X, Y, sWo, sbo);
      __syncwarp();
      i2t_norm(out + (static_cast<size_t>(p) * n + s * kStrip) * kC, Y, ln_w, ln_b, eps);
      __syncwarp();  // the strip is read out before the next one lands there
    }
    if (!shared_keys && i + 1 < i1) {
      stage_x(i + 1);
      cp_async_commit();
    }
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q: (B, T, 128) bf16, pre-scaled by 16^-0.5; keys: (Bk, N, 256) bf16 with
// Bk 1 or B; pe_wk: (N, 128) bf16; wk, wv: (128, 256) bf16 (out, in);
// bk, bv: (128) bf16; out: (B, T, 128) bf16. Any T >= 1, N % 32 == 0.
extern "C" int iuvl_t2i_stream(const void* q, const void* keys, const void* pe_wk, const void* wk,
                               const void* bk, const void* wv, const void* bv, void* out,
                               int batch, int keys_batch, int n, int tokens, void* stream) {
  if (tokens < 1 || n % kKT || (keys_batch != 1 && keys_batch != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks_y = (tokens + kTT * kTok - 1) / (kTT * kTok);
  return launch_kernel(t2i_stream_kernel, dim3(batch, blocks_y), T2iSmem::kBytes, stream,
                       static_cast<const bf16*>(q), static_cast<const bf16*>(keys),
                       static_cast<const bf16*>(pe_wk), static_cast<const bf16*>(wk),
                       static_cast<const bf16*>(bk), static_cast<const bf16*>(wv),
                       static_cast<const bf16*>(bv), static_cast<bf16*>(out), n, tokens,
                       static_cast<int>(keys_batch == 1 && batch > 1));
}

// keys: (Bk, N, 256) bf16 with Bk 1 or B; pe_wq: (N, 128) bf16; kp, vp:
// (B, T, 128) bf16; wq: (128, 256) and wo: (256, 128) bf16 (out, in); bq:
// (128) and bo: (256) bf16; ln_w, ln_b: (256) fp32; out: (B, N, 256) bf16.
// 1 <= T <= 64, N % 32 == 0.
extern "C" int iuvl_i2t_block_step(const void* keys, const void* pe_wq, const void* kp,
                                   const void* vp, const void* wq, const void* bq, const void* wo,
                                   const void* bo, const void* ln_w, const void* ln_b, void* out,
                                   int batch, int keys_batch, int n, int tokens, float scale,
                                   float eps, void* stream) {
  if (batch < 1 || tokens < 1 || tokens > kMaxTok || n < 32 || n % 32 ||
      (keys_batch != 1 && keys_batch != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceInfo dev = device_info();
  const int sms = dev.sms, max_smem = dev.smem_per_block;
  // Two token stages where they fit beside 8 warps' x strips, else one;
  // fewer warps only where one stage does not fit beside 8 strips.
  const size_t stage = size_t{2} * ((tokens + 15) / 16 * 16) * kLdI * 2;
  int stages = 2, nw = kWarps;
  auto bytes = [&] { return kRegionA + kRegionB + kParams + stages * stage + nw * kSlot; };
  while (bytes() > static_cast<size_t>(max_smem)) {
    if (stages == 2) stages = 1;
    else if (--nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (n / kStrip + nw - 1) / nw;
  const int grid = min(sms, batch * groups);
  const cudaError_t err = cudaFuncSetAttribute(
      i2t_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  i2t_block_kernel<<<grid, nw * 32, bytes(), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(pe_wq),
      static_cast<const bf16*>(kp), static_cast<const bf16*>(vp), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<bf16*>(out),
      batch, n, tokens, static_cast<int>(keys_batch == 1 && batch > 1), scale, eps, stages);
  return static_cast<int>(cudaGetLastError());
}
