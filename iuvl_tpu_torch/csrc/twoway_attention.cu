// The SAM two-way transformer's two cross attentions over the per-prompt
// image keys (B, N, C), each one pass over the keys:
//
// - t2i_stream_kernel (token -> image; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:t2i_stream): per key tile,
//   kp = x @ Wk^T + pe_wk + bk and vp = x @ Wv^T + bv, then an online
//   softmax over the image axis for every (token, head) row of the prompt's
//   pre-scaled queries. Writes only the (B, T, I) head-merged output.
// - i2t_block_kernel (image -> token; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:i2t_block_step): per tile of
//   image rows, qp = x @ Wq^T + pe_wq + bq, attention over the prompt's T
//   tokens per head, out-projection, residual and the block's LayerNorm.
//   Reads keys once and writes the updated keys once.
//
// Bound on the card, SAM's decoder (C 256, I 128, 8 heads of 16, T tokens:
// 7 for a one-point prompt), a chunk of B = 256 prompts over N = 4096
// image tokens: each
// kernel does 2*B*N*C*I*2 = 137 GFLOP of projections on the tensor cores
// against 537 MB (t2i: one read) or 1.07 GB (i2t: read + write) of keys;
// the attention itself (T = 7 tokens) is 1/16 of that. So both are
// tensor-core bound at the projections once the keys stream.
//
// Any T >= 1 (a click loop's 20 points make 26 tokens): t2i keeps the
// online-softmax state of up to kTT 16-row token tiles in registers and
// loops over them after each key tile's projection; a prompt of more
// tiles takes more blocks (grid.y), each projecting the keys again. i2t
// keeps up to 16 tokens' k, v in shared memory and does the softmax over
// them in one pass; past 16 tokens it reads k and v from device memory
// (L1-resident, a few KB a prompt) in 16-token tiles, first the max and
// sum, then the probabilities: the softmax masks the tokens past T.
//
// The TPU kernels packed the 8 heads block-diagonally ((head, token) rows
// against 128-wide columns) so that the MXU saw dense 128-lane matmuls.
// On the card a head is a 16-wide slice: t2i gives each warp one head, and
// its scores Q_h (16 padded token rows x 16) @ Kp_h^T are one 16x16x16 mma
// per 16 keys; i2t's attention over T tokens is T dot products of 16 per
// (row, head), done by one thread each in fp32 (one mma per 16-row tile
// and head measured slower: its chain of dependent steps is longer). The
// projection weights
// (128 KB) stay in shared memory for the whole block, the key tiles (and
// in i2t each prompt's token k/v) stream through two-slot cp.async rings,
// and rows are padded by 16 bytes so that fragment loads do not conflict
// on banks. In the projection epilogues a lane owns 8 contiguous columns:
// its bias and PE values come as 16-byte loads issued ahead of the
// products (i2t: once per block), its results go out as 16-byte stores.
//
// When the keys are batch-1 (block 0 of the decoder: every prompt shares
// the image embedding), i2t computes the query projection of a row tile
// once for its 16 prompts; t2i recomputes the k/v projection per prompt
// (one block per prompt), which costs what a per-prompt call costs.
//
// Rounding points follow the TPU kernels: products accumulate in fp32 and
// are rounded to bf16, then each bias or PE term is added and rounded in
// turn; scores and softmax in fp32; probabilities rounded to bf16 before
// p @ v; the online softmax rounds the unnormalised p (as t2i_stream);
// LayerNorm in fp32 with the two-pass variance.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kC = 256;      // embedding width
constexpr int kI = 128;      // attention width (C / 2)
constexpr int kHd = 16;      // head dim (8 heads)
constexpr int kTok = 16;     // tokens a tile (t2i) / held in shared memory (i2t)
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

// q . k over one 16-wide head, fp32, in the order of the i2t attention.
__device__ __forceinline__ float dot16(const float* qv, const bf16* k) {
  const uint4 k0 = load8(k), k1 = load8(k + 8);
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) dot += qv[d] * at8(k0, d);
#pragma unroll
  for (int d = 0; d < 8; ++d) dot += qv[8 + d] * at8(k1, d);
  return dot;
}

// o += p v over one 16-wide head.
__device__ __forceinline__ void add_pv(float* o, float p, const bf16* v) {
  const uint4 v0 = load8(v), v1 = load8(v + 8);
#pragma unroll
  for (int d = 0; d < 8; ++d) o[d] += p * at8(v0, d);
#pragma unroll
  for (int d = 0; d < 8; ++d) o[8 + d] += p * at8(v1, d);
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
constexpr int kRT = 32;  // image rows per block
constexpr int kPP = 16;  // prompts per block

struct I2tSmem {
  static constexpr size_t kWq = kI * kLdC * sizeof(bf16);
  static constexpr size_t kWo = kC * kLdI * sizeof(bf16);
  static constexpr size_t kX = kRT * kLdC * sizeof(bf16);  // x tile (two slots), y tile
  static constexpr size_t kQ = kRT * kLdI * sizeof(bf16);  // qp tile, attention tile
  static constexpr size_t kKV = 2 * kTok * kI * sizeof(bf16);  // a prompt's kp, vp; two slots
  static constexpr size_t kSt = kWarps * 256 * sizeof(float);
  static constexpr size_t kBytes = kWq + kWo + 3 * kX + 2 * kQ + 2 * kKV + kSt;
};

__global__ void __launch_bounds__(kThreads) i2t_block_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ pe_wq, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const bf16* __restrict__ wq, const bf16* __restrict__ bq,
    const bf16* __restrict__ wo, const bf16* __restrict__ bo, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bf16* __restrict__ out, int batch, int n, int tokens,
    int shared_keys, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sWq = reinterpret_cast<bf16*>(smem);
  bf16* sWo = sWq + kI * kLdC;
  bf16* sX = sWo + kC * kLdI;  // two slots
  bf16* sY = sX + 2 * kRT * kLdC;
  bf16* sQ = sY + kRT * kLdC;
  bf16* sA = sQ + kRT * kLdI;
  bf16* sKV = sA + kRT * kLdI;  // two slots of kp (kTok x kI) then vp
  float* st = reinterpret_cast<float*>(sKV + 4 * kTok * kI) + (threadIdx.x >> 5) * 256;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kRT;
  const int p0 = blockIdx.y * kPP, p1 = min(p0 + kPP, batch);
  auto x_rows = [&](int p) {
    return keys + (static_cast<size_t>(shared_keys ? 0 : p) * n + r0) * kC;
  };
  const bool staged = tokens <= kTok;  // else k, v are read from device memory
  auto stage_kv = [&](int slot, int p) {  // rows past `tokens` stay zero
    if (!staged) return;
    bf16* d = sKV + slot * 2 * kTok * kI;
    const size_t g = static_cast<size_t>(p) * tokens * kI;
    stage_rows(d, kI, kp + g, kI, tokens, kI);
    stage_rows(d + kTok * kI, kI, vp + g, kI, tokens, kI);
  };
  for (int i = tid; i < 4 * (kTok - tokens) * kI; i += kThreads) {
    const int part = i / ((kTok - tokens) * kI), j = i % ((kTok - tokens) * kI);
    sKV[part * kTok * kI + tokens * kI + j] = to_bf(0.f);
  }

  stage_rows(sWq, kLdC, wq, kC, kI, kC);
  stage_rows(sWo, kLdI, wo, kI, kC, kI);
  stage_rows(sX, kLdC, x_rows(p0), kC, kRT, kC);
  stage_kv(0, p0);
  cp_async_commit();
  // This warp's tiles: of qp, row tile rt and column tiles qct, qct+1; of
  // the out-projection, row tile rt and column tiles oct..oct+3. In an
  // epilogue a lane owns row er and columns ec..ec+7 of a 16x16 tile, so
  // its PE and bias values are the same for every prompt of the block:
  // registers, loaded once.
  const int rt = warp & 1, qct = (warp >> 1) * 2, oct = (warp >> 1) * 4;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  uint4 pe[2], bqv[2], bov[4];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = (qct + u) * 16 + ec;
    pe[u] = load8(pe_wq + static_cast<size_t>(r0 + rt * 16 + er) * kI + c);
    bqv[u] = load8(bq + c);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) bov[u] = load8(bo + (oct + u) * 16 + ec);

  for (int p = p0; p < p1; ++p) {
    const int it = p - p0;
    const bf16* X = sX + (shared_keys ? 0 : (it & 1)) * kRT * kLdC;
    // The other slots held the previous prompt's x (last read before the
    // barrier after its out-projection) and kp, vp (last read before the
    // barrier after its attention).
    if (p + 1 < p1) {
      if (!shared_keys)
        stage_rows(sX + ((it + 1) & 1) * kRT * kLdC, kLdC, x_rows(p + 1), kC, kRT, kC);
      stage_kv((it + 1) & 1, p + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* sKp = sKV + (it & 1) * 2 * kTok * kI;
    const bf16* sVp = sKp + kTok * kI;

    if (!shared_keys || it == 0) {  // qp = x @ Wq^T + pe_wq + bq -> sQ
      const int ct = qct;
      FragC qc[2];
      wmma::fill_fragment(qc[0], 0.f);
      wmma::fill_fragment(qc[1], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < kC; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, X + rt * 16 * kLdC + kk, kLdC);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragBc fb;  // B[k][n] = Wq[(ct+u)*16 + n][kk + k]
          wmma::load_matrix_sync(fb, sWq + (ct + u) * 16 * kLdC + kk, kLdC);
          wmma::mma_sync(qc[u], fa, fb, qc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        wmma::store_matrix_sync(st, qc[u], 16, wmma::mem_row_major);
        __syncwarp();
        uint4 packed;
        bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = to_bf(round_bf(round_bf(st[er * 16 + ec + j]) + at8(pe[u], j)) + at8(bqv[u], j));
        *reinterpret_cast<uint4*>(sQ + (rt * 16 + er) * kLdI + (ct + u) * 16 + ec) = packed;
        __syncwarp();
      }
      __syncthreads();
    }

    {  // attention of (row, head) = (tid / 8, tid % 8) over the T tokens
      const int r = tid >> 3, h = tid & 7;
      float qv[kHd];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 q8 = load8(sQ + r * kLdI + h * kHd + half * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[half * 8 + j] = at8(q8, j);
      }
      float o[kHd];
#pragma unroll
      for (int d = 0; d < kHd; ++d) o[d] = 0.f;
      if (staged) {  // one pass over the tokens held in shared memory
        float s[kTok], mx = kNegInf;
#pragma unroll
        for (int t = 0; t < kTok; ++t) {  // `tokens` is the same for the whole block
          if (t < tokens) {
            s[t] = dot16(qv, sKp + t * kI + h * kHd) * scale;
            mx = fmaxf(mx, s[t]);
          }
        }
        float den = 0.f;
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          if (t < tokens) {
            s[t] = expf(s[t] - mx);
            den += s[t];
          }
        }
#pragma unroll
        for (int t = 0; t < kTok; ++t)
          if (t < tokens) add_pv(o, round_bf(s[t] / den), sVp + t * kI + h * kHd);
      } else {  // 16-token tiles from device memory: the max and sum, then p v
        const bf16* kg = kp + static_cast<size_t>(p) * tokens * kI + h * kHd;
        const bf16* vg = vp + static_cast<size_t>(p) * tokens * kI + h * kHd;
        float mx = kNegInf, den = 0.f;
        for (int t0 = 0; t0 < tokens; t0 += kTok) {
          float s[kTok], mt = kNegInf;
#pragma unroll
          for (int t = 0; t < kTok; ++t) {
            s[t] = kNegInf;
            if (t0 + t < tokens) {
              s[t] = dot16(qv, kg + static_cast<size_t>(t0 + t) * kI) * scale;
              mt = fmaxf(mt, s[t]);
            }
          }
          const float m_new = fmaxf(mx, mt);
          den *= expf(mx - m_new);
#pragma unroll
          for (int t = 0; t < kTok; ++t)
            if (t0 + t < tokens) den += expf(s[t] - m_new);
          mx = m_new;
        }
        for (int t = 0; t < tokens; ++t) {
          const float st = dot16(qv, kg + static_cast<size_t>(t) * kI) * scale;
          add_pv(o, round_bf(expf(st - mx) / den), vg + static_cast<size_t>(t) * kI);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 packed;
        bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) ov[j] = to_bf(o[half * 8 + j]);
        *reinterpret_cast<uint4*>(sA + r * kLdI + h * kHd + half * 8) = packed;
      }
    }
    __syncthreads();

    {  // y = x + (att @ Wo^T + bo) -> sY
      const int ct = oct;
      FragC oc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wmma::fill_fragment(oc[u], 0.f);
#pragma unroll
      for (int kk = 0; kk < kI; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, sA + rt * 16 * kLdI + kk, kLdI);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          FragBc fb;  // B[k][n] = Wo[(ct+u)*16 + n][kk + k]
          wmma::load_matrix_sync(fb, sWo + (ct + u) * 16 * kLdI + kk, kLdI);
          wmma::mma_sync(oc[u], fa, fb, oc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wmma::store_matrix_sync(st, oc[u], 16, wmma::mem_row_major);
        __syncwarp();
        const int off = (rt * 16 + er) * kLdC + (ct + u) * 16 + ec;
        const uint4 xv = load8(X + off);
        uint4 packed;
        bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = to_bf(at8(xv, j) + round_bf(round_bf(st[er * 16 + ec + j]) + at8(bov[u], j)));
        *reinterpret_cast<uint4*>(sY + off) = packed;
        __syncwarp();
      }
    }
    __syncthreads();

    // LayerNorm of each row (warp: its 4 rows together; lane: 8 contiguous
    // columns), two-pass variance.
    {
      constexpr int kR = kRT / kWarps;
      float v[kR][8], sum[kR], sq[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const uint4 raw = load8(sY + (warp * kR + rr) * kLdC + lane * 8);
        sum[rr] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[rr][j] = at8(raw, j);
          sum[rr] += v[rr][j];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], o);
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        sum[rr] /= kC;  // the mean
        sq[rr] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) sq[rr] += (v[rr][j] - sum[rr]) * (v[rr][j] - sum[rr]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) sq[rr] += __shfl_xor_sync(0xffffffffu, sq[rr], o);
      const float4* w4 = reinterpret_cast<const float4*>(ln_w + lane * 8);
      const float4* b4 = reinterpret_cast<const float4*>(ln_b + lane * 8);
      const float4 wa = w4[0], wb = w4[1], ba = b4[0], bb = b4[1];
      const float w8[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float b8[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float rstd = rsqrtf(sq[rr] / kC + eps);
        uint4 packed;
        bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) ov[j] = to_bf((v[rr][j] - sum[rr]) * rstd * w8[j] + b8[j]);
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(p) * n + r0 + warp * kR + rr) * kC +
                                  lane * 8) = packed;
      }
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
// Any T >= 1, N % 32 == 0.
extern "C" int iuvl_i2t_block_step(const void* keys, const void* pe_wq, const void* kp,
                                   const void* vp, const void* wq, const void* bq, const void* wo,
                                   const void* bo, const void* ln_w, const void* ln_b, void* out,
                                   int batch, int keys_batch, int n, int tokens, float scale,
                                   float eps, void* stream) {
  if (tokens < 1 || n % kRT || (keys_batch != 1 && keys_batch != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kRT, (batch + kPP - 1) / kPP);
  return launch_kernel(i2t_block_kernel, grid, I2tSmem::kBytes, stream,
                       static_cast<const bf16*>(keys), static_cast<const bf16*>(pe_wq),
                       static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
                       static_cast<const bf16*>(wq), static_cast<const bf16*>(bq),
                       static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
                       static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                       static_cast<bf16*>(out), batch, n, tokens,
                       static_cast<int>(keys_batch == 1 && batch > 1), scale, eps);
}
