// SAM's whole-chunk decode tail (B16). Replaces the Pallas kernel
// decode_tail (iuvl_tpu/ops/pallas/decode_chunk.py:511, pallas_call at
// :491): for each prompt of a chunk over one shared image embedding, block
// 0's image -> token step, all of block 1 (self-attention, token -> image,
// MLP, image -> token), the final token -> image attention and its norm,
// the hypernetwork MLPs, the two 2x2/s2 deconvs with their LayerNorm2d and
// GELUs, and the mask contraction. Writes the (B, Tp, 256) bf16 tokens
// and the (B, N, 64) fp32 mask logits, columns (di, dj, ei, ej, t), and
// leaves keys2 in a (B, N, 256) bf16 workspace. Tp, the token slots
// (t_valid of them real), is any multiple of 16: 16 (a one-point prompt's 7
// tokens), 32 (the interactive click loop's 26), ..., 96 (an 80-point
// prompt's 86). Any N >= 1.
//
// The TPU kernel kept a prompt's 2 MB keys row (N 4096 x C 256 bf16) in
// VMEM and ran the whole chain for one prompt per grid step, with
// block-diagonal selector matrices so that every head product was a dense
// 2-D matmul for the MXU. An SM has 228 KB of shared memory, so that design
// does not carry over. What carries over is the function's structure:
// given the prompt's token rows, every keys-side step is local to an
// image row, and only two steps reduce over the N rows (t2i1 and the final
// t2i); the hypernetwork needs the tokens after the second. Those keys-side
// steps are the functions of B5 (the image -> token block step) and B4 (the
// token -> image attention), and the upscale is B6's: this entry runs their
// kernels (twoway_attention.cuh, mask_upscale.cuh) between three token
// passes of its own, ten launches in a fixed order on the stream (past 64
// slots more, below):
//
//   1. tok_front   (a block a prompt): block 1's self-attention and norm1,
//                  then t2i1's queries.
//   2. B5 over the shared keys0 (batch-1 keys: a strip's q-projection made
//                  once for every prompt): block 0's image -> token step
//                  over the prompt's t_valid slots, out-projection,
//                  residual, norm4 -> keys1.
//   3. B4 on keys1 (and its merge): t2i1's k, v a 64-row wgmma tile with
//                  [Wk; Wv] resident, the online softmax in registers, the
//                  key axis split into ranges (t2i_plan: about 2x the SMs
//                  in work items), the ranges' partials merged in order.
//   4. tok_mid     (a block a prompt): out-proj, norm2, the MLP (2048),
//                  norm3; i2t1's token-side k, v and the final queries.
//   5. B5 on keys1: i2t1 (q-projection with PE, attention over the slots
//                  in registers, out-proj, residual, norm4) -> keys2.
//   6. B4 on keys2 (and its merge): the final attention.
//   7. tok_tail    (a block a prompt): out-proj, the final norm ->
//                  tokens; the three hypernetwork layers of the 4 mask
//                  tokens (CUDA-core dot products) -> hyper (4, 32).
//   8. B6 on keys2, its fp32 epilogue: deconv1, LayerNorm2d, GELU, deconv2
//                  per (di, dj) group, GELU, the contraction with hyper.
//
// The token passes keep Tp rows of every token-side operand in shared
// memory; the MLP hidden (Tp x 2048) streams through it in chunks of kHc
// columns, its second product summed in registers across the chunks, so
// Tp 64 fits (211 KB in tok_front). Their products run on wmma 16x16x16
// with weight fragments read from L2. Past 64 slots (C8) the token passes
// run a block a (prompt, 64-row tile), the last tile Tp % 64 rows: tok_mid
// and tok_tail are row-local (the hypernetwork reads the mask tokens, rows
// 1-4 of the first tile), and tok_front, whose self-attention reads every
// slot's k and v, splits in two: tok_front_kv writes the tiles' k and v to
// a (B, 2, Tp, C) workspace, then tok_front_att attends each tile's
// queries over them from device memory (the max, the sum and p v in three
// passes over the slots, the scores recomputed: the arithmetic of
// tok_front's registers). Up to 64 slots the passes are the ones above.
//
// Bound on the card (chip_smoke.py `work`): operations. At the chunk
// serving shape (256 prompts, N 4096) the least work is ~0.72 TFLOP
// (seven N x 256 x 128 projections a prompt, the deconvs, the attention
// products and the contraction): ~0.73 ms at 989 TFLOP/s; the bytes a
// call must move (the 268 MB of fp32 masks, the inputs once) take ~0.08
// ms. This design moves more: keys1 and keys2 through two 512 MB bf16
// workspaces (written once, read twice each: 3 GB a chunk, ~0.9 ms at
// 3.35 TB/s), and the token passes read the MLP weights from L2 once a
// prompt. No atomics: two launches give the same bits. On the card (H100
// SXM, 700 W; tools/kernel_ab.py, PERF.md §6) 4.05 ms at the chunk serving
// shape: B5 1.49 (both calls), B4 1.01, B6 1.02, the token passes 0.36.
//
// Rounding follows the TPU kernel: each product rounded to bf16, then its
// PE term and bias added and rounded in turn, then the residual (B5's
// kResFirst order); scores and softmax in fp32, probabilities rounded to
// bf16 before the product with v (the t2i partials round the unnormalised
// probabilities per 64-key tile, as B4 does); LayerNorms in fp32 with the
// two-pass variance (eps 1e-5), LayerNorm2d with E[x^2] - E[x]^2 (eps
// 1e-6); tanh GELU on bf16 values; the masks summed and stored in fp32.
#include <initializer_list>

#include "mask_upscale.cuh"
#include "twoway_attention.cuh"

namespace iuvl {
namespace {

constexpr int kC = 256, kI = 128, kH = 8, kHd = 16, kHs = 32, kM = 4;
constexpr int kC8 = 32, kMlp = 2048;
constexpr int kHc = 256;       // MLP hidden columns a chunk in tok_mid
constexpr int kLdC = kC + 8, kLdI = kI + 8, kLdH = kHc + 8;
constexpr float kScaleI = 0.25f;                 // 16^-1/2
constexpr float kScaleC = 0.17677669529663687f;  // 32^-1/2
constexpr float kEps = 1e-5f;
constexpr int kOperands = 73;  // decode_chunk.py `_operands`
static_assert(kI / kHd == kWarps && kC / kHs == kH, "a warp per head");
static_assert(kC == 2 * 16 * kWarps && kMlp % kHc == 0, "mlp_stream: two column tiles a warp");

struct Attn {
  const bf16 *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
};

enum { LN40, LN11, LN21, LN31, LN41, LNF };

struct TailArgs {  // T: the token slots, Tp
  // t, tpe (B, T, C); keys0 (N, C); pewq0, pewq1, pewk1, pewkf (N, I); kbd0, vbd0 (B, T, I)
  const bf16 *t, *tpe, *keys0, *pewq0, *pewq1, *pewk1, *pewkf, *kbd0, *vbd0;
  const bf16 *i0_wq, *i0_bq, *i0_wo, *i0_bo;
  Attn self1, t2i1, i2t1, fin;  // nn.Linear layout (out, in)
  const bf16 *m_w1, *m_b1, *m_w2, *m_b2;
  const float* ln[6][2];  // ln40, ln11, ln21, ln31, ln41, lnf: scale, bias
  const bf16 *h_w[3], *h_b[3];  // (M, out, in), (M, out)
  const bf16 *u_w1, *u_b1;
  const float *u_lnw, *u_lnb;
  const bf16 *u_w2, *u_b2;
  bf16* tok;     // (B, T, C)
  float* masks;  // (B, N, 16 M)
  bf16* keys1;   // (B, N, C)
  bf16* keys2;   // (B, N, C)
  float* part_o;   // B4's partials: (B, splits, T, I)
  float* part_ml;  // (B, splits, T, H, 2)
  bf16* att;     // (B, T, I): B4's merged output, t2i1's, then the final one's
  bf16* tstate;  // (B, T, C): the token state between the passes
  bf16* q_ws;    // (B, T, I): t2i1's queries, then the final attention's
  bf16* kv_ws;   // (B, 2, T, I): i2t1's token-side k, v
  bf16* hyper;   // (B, M, C8)
  bf16* kv_self; // (B, 2, T, C): block 1's self-attention k, v past 64 slots
  int n, t_valid, splits, tp;
};

__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ float at8(const uint4& v, int j) {
  return to_f(reinterpret_cast<const bf16*>(&v)[j]);
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 packed;
  bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = to_bf(v[j]);
  *reinterpret_cast<uint4*>(p) = packed;
}
// dst[0..8) = bf16(round(v) + bias): a product rounded, then its bias added.
__device__ __forceinline__ void store_biased(bf16* dst, const float v[8], const bf16* bias) {
  const uint4 bv = load8(bias);
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = round_bf(v[j]) + at8(bv, j);
  store8(dst, o);
}
// dst[0..8) = bf16(round(x + round(v)) + bias): a residual, then the bias.
__device__ __forceinline__ void store_residual(bf16* dst, const bf16* x, const float v[8],
                                               const bf16* bias) {
  const uint4 xv = load8(x), bv = load8(bias);
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = round_bf(at8(xv, j) + round_bf(v[j])) + at8(bv, j);
  store8(dst, o);
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0) into shared memory at
// stride `ld`, by cp.async in 16-byte pieces.
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src, size_t src_ld,
                                           int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec, v = i % vec;
    cp_async16(dst + r * ld + v * 8, src + r * src_ld + v * 8);
  }
}

// dst = bf16(a + b) over kT rows of kC (shared, stride kLdC).
template <int kT>
__device__ __forceinline__ void add_rows(bf16* dst, const bf16* a, const bf16* b) {
  for (int i = threadIdx.x; i < kT * kC / 8; i += kThreads) {
    const int off = (i / (kC / 8)) * kLdC + (i % (kC / 8)) * 8;
    const uint4 x = load8(a + off), y = load8(b + off);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = at8(x, j) + at8(y, j);
    store8(dst + off, o);
  }
}

// kRows (a multiple of 16) token rows A (shared, stride lda, depth k) times W^T, W
// (nout, k) in nn.Linear layout in device memory. A warp per 16-column
// tile of the result, each weight fragment read once for every row tile;
// each lane gets row er of each 16-row tile, columns c..c+7: epi(row, c, v).
template <int kRows, typename Epi>
__device__ __forceinline__ void tok_gemm(const bf16* A, int lda, int k, const bf16* W, int nout,
                                         float* st, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  for (int ct = warp; ct < nout / 16; ct += kWarps) {
    FragC acc[kRows / 16];
#pragma unroll
    for (int rt = 0; rt < kRows / 16; ++rt) wmma::fill_fragment(acc[rt], 0.f);
    const bf16* w = W + static_cast<size_t>(ct) * 16 * k;
#pragma unroll 4
    for (int kk = 0; kk < k; kk += 16) {
      FragBc fb;  // B[k][n] = W[ct*16 + n][kk + k]
      wmma::load_matrix_sync(fb, w + kk, k);
#pragma unroll
      for (int rt = 0; rt < kRows / 16; ++rt) {
        FragA fa;
        wmma::load_matrix_sync(fa, A + rt * 16 * lda + kk, lda);
        wmma::mma_sync(acc[rt], fa, fb, acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < kRows / 16; ++rt) {
      wmma::store_matrix_sync(st, acc[rt], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = st[er * 16 + ec + j];
      __syncwarp();
      epi(rt * 16 + er, ct * 16 + ec, v);
    }
  }
}

// LayerNorm of `rows` rows of kC bf16 (shared, stride ld), a warp a row,
// fp32 with the two-pass variance; written bf16 to dst (stride ld) and, if
// out is set, to out (stride kC).
__device__ void ln_rows(const bf16* src, bf16* dst, int ld, int rows, const float* w,
                        const float* b, bf16* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wv[8], bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wv[j] = w[lane * 8 + j];
    bv[j] = b[lane * 8 + j];
  }
  for (int r = warp; r < rows; r += kWarps) {
    const uint4 raw = load8(src + r * ld + lane * 8);
    float v[8], s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = at8(raw, j);
      s += v[j];
    }
    const float mean = warp_sum(s) / kC;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sq += (v[j] - mean) * (v[j] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / kC + kEps);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] - mean) * rstd * wv[j] + bv[j];
    store8(dst + r * ld + lane * 8, v);
    if (out) store8(out + static_cast<size_t>(r) * kC + lane * 8, v);
  }
}

// -------------------------------------------------------------- tok_front --
template <int kT>
constexpr size_t kFrontSmem = 6 * kT * kLdC * sizeof(bf16) + kWarps * 256 * sizeof(float);

template <int kT>
__global__ void __launch_bounds__(kThreads) tok_front_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);  // t
  bf16* sE = sT + kT * kLdC;                 // tpe
  bf16* sU = sE + kT * kLdC;                 // t + tpe; then the residual sum, t1, t1 + tpe
  bf16* sQ = sU + kT * kLdC;                 // self-attention q, then its output
  bf16* sK = sQ + kT * kLdC;
  bf16* sV = sK + kT * kLdC;
  bf16* sY = sU;  // free once q and k are made
  float* st = reinterpret_cast<float*>(sV + kT * kLdC) + (threadIdx.x >> 5) * 256;
  const int tid = threadIdx.x, b = blockIdx.x;
  stage_rows(sT, kLdC, a.t + static_cast<size_t>(b) * kT * kC, kC, kT, kC);
  stage_rows(sE, kLdC, a.tpe + static_cast<size_t>(b) * kT * kC, kC, kT, kC);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  add_rows<kT>(sU, sT, sE);
  __syncthreads();
  const Attn& w = a.self1;
  tok_gemm<kT>(sU, kLdC, kC, w.wq, kC, st,
           [&](int r, int c, const float* v) { store_biased(sQ + r * kLdC + c, v, w.bq + c); });
  tok_gemm<kT>(sU, kLdC, kC, w.wk, kC, st,
           [&](int r, int c, const float* v) { store_biased(sK + r * kLdC + c, v, w.bk + c); });
  tok_gemm<kT>(sT, kLdC, kC, w.wv, kC, st,
           [&](int r, int c, const float* v) { store_biased(sV + r * kLdC + c, v, w.bv + c); });
  __syncthreads();
  for (int pair = tid; pair < kT * kH; pair += kThreads) {
    // (query, head): attention over the valid slots, into its own slice of sQ
    const int q = pair >> 3, h = pair & 7;
    float qv[kHs];
#pragma unroll
    for (int u = 0; u < kHs / 8; ++u) {
      const uint4 x = load8(sQ + q * kLdC + h * kHs + u * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) qv[u * 8 + j] = at8(x, j);
    }
    float s[kT], mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (t < a.t_valid) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < kHs / 8; ++u) {
          const uint4 x = load8(sK + t * kLdC + h * kHs + u * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) dot += qv[u * 8 + j] * at8(x, j);
        }
        s[t] = dot * kScaleC;
        mx = fmaxf(mx, s[t]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t)
      if (t < a.t_valid) {
        s[t] = expf(s[t] - mx);
        den += s[t];
      }
    float o[kHs] = {};
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (t < a.t_valid) {
        const float p = round_bf(s[t] / den);
#pragma unroll
        for (int u = 0; u < kHs / 8; ++u) {
          const uint4 x = load8(sV + t * kLdC + h * kHs + u * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) o[u * 8 + j] += p * at8(x, j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kHs / 8; ++u) store8(sQ + q * kLdC + h * kHs + u * 8, o + u * 8);
  }
  __syncthreads();
  tok_gemm<kT>(sQ, kLdC, kC, w.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT + r * kLdC + c, v, w.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sY, kLdC, kT, a.ln[LN11][0], a.ln[LN11][1],
          a.tstate + static_cast<size_t>(b) * kT * kC);
  __syncthreads();
  add_rows<kT>(sU, sY, sE);  // in place: sY is sU
  __syncthreads();
  bf16* q1 = a.q_ws + static_cast<size_t>(b) * kT * kI;
  tok_gemm<kT>(sU, kLdC, kC, a.t2i1.wq, kI, st, [&](int r, int c, const float* v) {
    const uint4 bv = load8(a.t2i1.bq + c);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = round_bf(round_bf(v[j]) + at8(bv, j)) * kScaleI;
    store8(q1 + r * kI + c, o);
  });
}

// ------------------------------------------------ tok_front past 64 slots --
template <int kT>
constexpr size_t kFrontKvSmem = 3 * kT * kLdC * sizeof(bf16) + kWarps * 256 * sizeof(float);

// Rows r0 + 64 blockIdx.y .. + kT of prompt blockIdx.x: block 1's
// self-attention k = bf16(round((t + tpe) Wk^T) + bk) and v (of t) into
// a.kv_self, as tok_front makes them in shared memory.
template <int kT>
__global__ void __launch_bounds__(kThreads) tok_front_kv_kernel(TailArgs a, int r0) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);
  bf16* sE = sT + kT * kLdC;
  bf16* sU = sE + kT * kLdC;
  float* st = reinterpret_cast<float*>(sU + kT * kLdC) + (threadIdx.x >> 5) * 256;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * a.tp + r0 + blockIdx.y * 64;
  stage_rows(sT, kLdC, a.t + row * kC, kC, kT, kC);
  stage_rows(sE, kLdC, a.tpe + row * kC, kC, kT, kC);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  add_rows<kT>(sU, sT, sE);
  __syncthreads();
  const Attn& w = a.self1;
  bf16* k = a.kv_self + (static_cast<size_t>(b) * 2 * a.tp + r0 + blockIdx.y * 64) * kC;
  bf16* v = k + static_cast<size_t>(a.tp) * kC;
  tok_gemm<kT>(sU, kLdC, kC, w.wk, kC, st,
           [&](int r, int c, const float* x) { store_biased(k + r * kC + c, x, w.bk + c); });
  tok_gemm<kT>(sT, kLdC, kC, w.wv, kC, st,
           [&](int r, int c, const float* x) { store_biased(v + r * kC + c, x, w.bv + c); });
}

template <int kT>
constexpr size_t kFrontAttSmem = 4 * kT * kLdC * sizeof(bf16) + kWarps * 256 * sizeof(float);

// tok_front for the kT rows of a tile, its self-attention over the Tp
// slots' k and v in a.kv_self.
template <int kT>
__global__ void __launch_bounds__(kThreads) tok_front_att_kernel(TailArgs a, int r0) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);  // t
  bf16* sE = sT + kT * kLdC;                 // tpe
  bf16* sU = sE + kT * kLdC;                 // t + tpe; then the residual sum, t1, t1 + tpe
  bf16* sQ = sU + kT * kLdC;                 // self-attention q, then its output
  bf16* sY = sU;
  float* st = reinterpret_cast<float*>(sQ + kT * kLdC) + (threadIdx.x >> 5) * 256;
  const int tid = threadIdx.x, b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * a.tp + r0 + blockIdx.y * 64;
  stage_rows(sT, kLdC, a.t + row * kC, kC, kT, kC);
  stage_rows(sE, kLdC, a.tpe + row * kC, kC, kT, kC);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  add_rows<kT>(sU, sT, sE);
  __syncthreads();
  const Attn& w = a.self1;
  tok_gemm<kT>(sU, kLdC, kC, w.wq, kC, st,
           [&](int r, int c, const float* v) { store_biased(sQ + r * kLdC + c, v, w.bq + c); });
  __syncthreads();
  const bf16* sK = a.kv_self + static_cast<size_t>(b) * 2 * a.tp * kC;
  const bf16* sV = sK + static_cast<size_t>(a.tp) * kC;
  for (int pair = tid; pair < kT * kH; pair += kThreads) {
    const int q = pair >> 3, h = pair & 7;
    float qv[kHs];
#pragma unroll
    for (int u = 0; u < kHs / 8; ++u) {
      const uint4 x = load8(sQ + q * kLdC + h * kHs + u * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) qv[u * 8 + j] = at8(x, j);
    }
    auto score = [&](int t) {
      float dot = 0.f;
#pragma unroll
      for (int u = 0; u < kHs / 8; ++u) {
        const uint4 x = load8(sK + t * kC + h * kHs + u * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += qv[u * 8 + j] * at8(x, j);
      }
      return dot * kScaleC;
    };
    float mx = kNegInf;
    for (int t = 0; t < a.t_valid; ++t) mx = fmaxf(mx, score(t));
    float den = 0.f;
    for (int t = 0; t < a.t_valid; ++t) den += expf(score(t) - mx);
    float o[kHs] = {};
    for (int t = 0; t < a.t_valid; ++t) {
      const float p = round_bf(expf(score(t) - mx) / den);
#pragma unroll
      for (int u = 0; u < kHs / 8; ++u) {
        const uint4 x = load8(sV + t * kC + h * kHs + u * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[u * 8 + j] += p * at8(x, j);
      }
    }
#pragma unroll
    for (int u = 0; u < kHs / 8; ++u) store8(sQ + q * kLdC + h * kHs + u * 8, o + u * 8);
  }
  __syncthreads();
  tok_gemm<kT>(sQ, kLdC, kC, w.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT + r * kLdC + c, v, w.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sY, kLdC, kT, a.ln[LN11][0], a.ln[LN11][1], a.tstate + row * kC);
  __syncthreads();
  add_rows<kT>(sU, sY, sE);  // in place: sY is sU
  __syncthreads();
  bf16* q1 = a.q_ws + row * kI;
  tok_gemm<kT>(sU, kLdC, kC, a.t2i1.wq, kI, st, [&](int r, int c, const float* v) {
    const uint4 bv = load8(a.t2i1.bq + c);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = round_bf(round_bf(v[j]) + at8(bv, j)) * kScaleI;
    store8(q1 + r * kI + c, o);
  });
}

// ---------------------------------------------------------------- tok_mid --
template <int kT>
constexpr size_t kMidSmem = (4 * kT * kLdC + kT * kLdI + kT * kLdH) * sizeof(bf16) +
                            kWarps * 256 * sizeof(float);

// Block 1's MLP over kT token rows X (shared, stride kLdC):
// epi(r, c, v) gets v = relu(round(X W1^T) + b1) W2^T, summed in fp32. The
// hidden passes through sH (kT x kHc) a chunk of kHc columns at a time;
// each warp keeps its two 16-column tiles of the second product in
// registers across the chunks, summing over the hidden in the same order
// as one pass over all 2048 would.
template <int kT, typename Epi>
__device__ void mlp_stream(const bf16* X, bf16* sH, const TailArgs& a, float* st, Epi epi) {
  constexpr int kRTs = kT / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int er = lane >> 1, ec = (lane & 1) * 8;
  FragC acc[2][kRTs];  // column tiles warp and warp + 8 of the (kT, kC) result
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rt = 0; rt < kRTs; ++rt) wmma::fill_fragment(acc[u][rt], 0.f);
  for (int h0 = 0; h0 < kMlp; h0 += kHc) {
    tok_gemm<kT>(X, kLdC, kC, a.m_w1 + static_cast<size_t>(h0) * kC, kHc, st,
                 [&](int r, int c, const float* v) {
                   const uint4 bv = load8(a.m_b1 + h0 + c);
                   float o[8];
#pragma unroll
                   for (int j = 0; j < 8; ++j) o[j] = fmaxf(round_bf(v[j]) + at8(bv, j), 0.f);
                   store8(sH + r * kLdH + c, o);
                 });
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bf16* w = a.m_w2 + static_cast<size_t>(warp + u * kWarps) * 16 * kMlp + h0;
#pragma unroll 4
      for (int kk = 0; kk < kHc; kk += 16) {
        FragBc fb;  // B[k][n] = W2[ct*16 + n][h0 + kk + k]
        wmma::load_matrix_sync(fb, w + kk, kMlp);
#pragma unroll
        for (int rt = 0; rt < kRTs; ++rt) {
          FragA fa;
          wmma::load_matrix_sync(fa, sH + rt * 16 * kLdH + kk, kLdH);
          wmma::mma_sync(acc[u][rt], fa, fb, acc[u][rt]);
        }
      }
    }
    __syncthreads();  // sH is read before the next chunk overwrites it
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int rt = 0; rt < kRTs; ++rt) {
      wmma::store_matrix_sync(st, acc[u][rt], 16, wmma::mem_row_major);
      __syncwarp();
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = st[er * 16 + ec + j];
      __syncwarp();
      epi(rt * 16 + er, (warp + u * kWarps) * 16 + ec, v);
    }
}

// Rows r0 + 64 blockIdx.y .. + kT of prompt blockIdx.x (up to 64 slots: all
// kT = Tp of them).
template <int kT>
__global__ void __launch_bounds__(kThreads) tok_mid_kernel(TailArgs a, int r0) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT1 = reinterpret_cast<bf16*>(smem);  // t1
  bf16* sE = sT1 + kT * kLdC;                 // tpe
  bf16* sU = sE + kT * kLdC;                  // t1 + tpe
  bf16* sY = sU + kT * kLdC;                  // residual sums
  bf16* sA = sY + kT * kLdC;                  // merged attention output
  bf16* sH = sA + kT * kLdI;                  // a chunk of the MLP's hidden
  float* st = reinterpret_cast<float*>(sH + kT * kLdH) + (threadIdx.x >> 5) * 256;
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * a.tp + r0 + blockIdx.y * 64;
  stage_rows(sT1, kLdC, a.tstate + row * kC, kC, kT, kC);
  stage_rows(sE, kLdC, a.tpe + row * kC, kC, kT, kC);
  stage_rows(sA, kLdI, a.att + row * kI, kI, kT, kI);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  tok_gemm<kT>(sA, kLdI, kI, a.t2i1.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.t2i1.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sT1, kLdC, kT, a.ln[LN21][0], a.ln[LN21][1], nullptr);
  __syncthreads();
  mlp_stream<kT>(sT1, sH, a, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.m_b2 + c);
  });
  __syncthreads();
  ln_rows(sY, sT1, kLdC, kT, a.ln[LN31][0], a.ln[LN31][1], a.tstate + row * kC);
  __syncthreads();
  add_rows<kT>(sU, sT1, sE);
  __syncthreads();
  bf16* kv = a.kv_ws + (static_cast<size_t>(b) * 2 * a.tp + r0 + blockIdx.y * 64) * kI;
  tok_gemm<kT>(sU, kLdC, kC, a.i2t1.wk, kI, st, [&](int r, int c, const float* v) {
    store_biased(kv + r * kI + c, v, a.i2t1.bk + c);
  });
  tok_gemm<kT>(sT1, kLdC, kC, a.i2t1.wv, kI, st, [&](int r, int c, const float* v) {
    store_biased(kv + (a.tp + r) * kI + c, v, a.i2t1.bv + c);
  });
  bf16* qf = a.q_ws + row * kI;
  tok_gemm<kT>(sU, kLdC, kC, a.fin.wq, kI, st, [&](int r, int c, const float* v) {
    const uint4 bv = load8(a.fin.bq + c);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = round_bf(round_bf(v[j]) + at8(bv, j)) * kScaleI;
    store8(qf + r * kI + c, o);
  });
}

// --------------------------------------------------------------- tok_tail --
template <int kT>
constexpr size_t kTailSmem = (2 * kT * kLdC + kT * kLdI) * sizeof(bf16) +
                             (2 * kM * kC + kWarps * 256) * sizeof(float);

// One hypernetwork layer of the 4 mask tokens: y[i, o] = bf16(round(x[i] .
// W[i, o, :]) + b[i, o]), ReLU unless last; fp32 sums on the CUDA cores.
__device__ void hyper_layer(const float* x, const bf16* W, const bf16* bias, int nout,
                            bool relu, float* y) {
  for (int o = threadIdx.x; o < kM * nout; o += kThreads) {
    const int i = o / nout;
    const bf16* w = W + static_cast<size_t>(o) * kC;
    const float* xi = x + i * kC;
    float s = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; c += 8) {
      const uint4 wv = load8(w + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += xi[c + j] * at8(wv, j);
    }
    const float v = round_bf(round_bf(s) + to_f(bias[o]));
    y[o] = relu ? fmaxf(v, 0.f) : v;
  }
}

// Rows as tok_mid's; the hypernetwork in the first tile's block.
template <int kT>
__global__ void __launch_bounds__(kThreads) tok_tail_kernel(TailArgs a, int r0) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT1 = reinterpret_cast<bf16*>(smem);
  bf16* sY = sT1 + kT * kLdC;
  bf16* sA = sY + kT * kLdC;
  float* hx = reinterpret_cast<float*>(sA + kT * kLdI);  // kM x kC
  float* hy = hx + kM * kC;
  float* st = hy + kM * kC + (threadIdx.x >> 5) * 256;
  const int b = blockIdx.x, r = r0 + blockIdx.y * 64;
  const size_t row = static_cast<size_t>(b) * a.tp + r;
  stage_rows(sT1, kLdC, a.tstate + row * kC, kC, kT, kC);
  stage_rows(sA, kLdI, a.att + row * kI, kI, kT, kI);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  tok_gemm<kT>(sA, kLdI, kI, a.fin.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.fin.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sY, kLdC, kT, a.ln[LNF][0], a.ln[LNF][1], a.tok + row * kC);
  if (r != 0) return;  // the mask tokens are rows 1-4 of the first tile
  __syncthreads();
  for (int i = threadIdx.x; i < kM * kC; i += kThreads)
    hx[i] = to_f(sY[(1 + i / kC) * kLdC + i % kC]);
  __syncthreads();
  hyper_layer(hx, a.h_w[0], a.h_b[0], kC, true, hy);
  __syncthreads();
  hyper_layer(hy, a.h_w[1], a.h_b[1], kC, true, hx);
  __syncthreads();
  hyper_layer(hx, a.h_w[2], a.h_b[2], kC8, false, hy);
  __syncthreads();
  if (threadIdx.x < kM * kC8)
    a.hyper[static_cast<size_t>(b) * kM * kC8 + threadIdx.x] = to_bf(hy[threadIdx.x]);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

namespace {

// The function's launches in the header's order. kT: Tp (up to 64, a block
// a prompt in each token pass), or 0 past 64 slots (the tiled passes).
template <int kT>
int launch_tail(const TailArgs& a, int batch, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tp = a.tp, full = kT ? 0 : tp / 64, rem = kT ? 0 : tp % 64;
  int err = 0;
  // One token pass: Tp <= 64 a block a prompt; past 64 a block a (prompt,
  // 64-row tile), then a block a prompt for the last Tp % 64 rows.
#define TOK_PASS(KERNEL, SMEM)                                                              \
  do {                                                                                      \
    if (kT) {                                                                               \
      if (!err) err = launch_kernel(KERNEL<kT ? kT : 16>, dim3(batch), SMEM<kT ? kT : 16>,  \
                                    stream, a, 0);                                          \
    } else {                                                                                \
      if (!err) err = launch_kernel(KERNEL<64>, dim3(batch, full), SMEM<64>, stream, a, 0); \
      if (!err && rem == 16)                                                                \
        err = launch_kernel(KERNEL<16>, dim3(batch), SMEM<16>, stream, a, full * 64);       \
      if (!err && rem == 32)                                                                \
        err = launch_kernel(KERNEL<32>, dim3(batch), SMEM<32>, stream, a, full * 64);       \
      if (!err && rem == 48)                                                                \
        err = launch_kernel(KERNEL<48>, dim3(batch), SMEM<48>, stream, a, full * 64);       \
    }                                                                                       \
  } while (0)
  if (kT) {
    err = launch_kernel(tok_front_kernel<kT ? kT : 16>, dim3(batch), kFrontSmem<kT ? kT : 16>,
                        stream, a);
  } else {
    TOK_PASS(tok_front_kv_kernel, kFrontKvSmem);
    TOK_PASS(tok_front_att_kernel, kFrontAttSmem);
  }
  if (!err)
    err = twoway::i2t_block_run<true>(a.keys0, a.pewq0, a.kbd0, a.vbd0, tp * kI, a.i0_wq,
                                      a.i0_bq, a.i0_wo, a.i0_bo, a.ln[LN40][0], a.ln[LN40][1],
                                      a.keys1, batch, 1, n, a.t_valid, kScaleI, kEps, st);
  if (!err)
    err = twoway::t2i_stream_run(a.q_ws, a.keys1, a.pewk1, a.t2i1.wk, a.t2i1.bk, a.t2i1.wv,
                                 a.t2i1.bv, a.att, nullptr, a.part_o, a.part_ml, batch, batch, n,
                                 tp, a.splits, st);
  TOK_PASS(tok_mid_kernel, kMidSmem);
  if (!err)
    err = twoway::i2t_block_run<true>(a.keys1, a.pewq1, a.kv_ws, a.kv_ws + tp * kI, 2 * tp * kI,
                                      a.i2t1.wq, a.i2t1.bq, a.i2t1.wo, a.i2t1.bo, a.ln[LN41][0],
                                      a.ln[LN41][1], a.keys2, batch, batch, n, a.t_valid,
                                      kScaleI, kEps, st);
  if (!err)
    err = twoway::t2i_stream_run(a.q_ws, a.keys2, a.pewkf, a.fin.wk, a.fin.bk, a.fin.wv,
                                 a.fin.bv, a.att, nullptr, a.part_o, a.part_ml, batch, batch, n,
                                 tp, a.splits, st);
  TOK_PASS(tok_tail_kernel, kTailSmem);
#undef TOK_PASS
  if (!err)
    err = upscale::masks_upscale_run<true>(a.keys2, a.u_w1, a.u_b1, a.u_lnw, a.u_lnb, a.u_w2,
                                           a.u_b2, a.hyper, a.masks, batch, n, st);
  return err;
}

}  // namespace

// p: kOperands pointers in the order of iuvl_tpu_torch/ops/cuda/decode_chunk.py
// `_operands` (inputs, precomputes, weights), then tokens_out, masks and
// the nine workspaces (keys1, keys2, B4's partials (o, then m and l, one
// fp32 buffer), B4's merged output, token state, queries, i2t1's k and v,
// hyper, and block 1's self-attention k and v (B, 2, tp, 256) bf16, read
// past 64 slots only). tp (the token slots) any multiple of 16, 1 <=
// t_valid <= tp, any N >= 1; `splits` B4's key ranges (twoway_attention.py
// t2i_plan).
extern "C" int iuvl_decode_tail(const void* const* p, int count, int batch, int n, int tp,
                                int t_valid, int splits, void* stream) {
  if (count != kOperands + 11 || tp < 16 || tp % 16 || t_valid < 1 || t_valid > tp || n < 1 ||
      batch < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a;
  int i = 0;
  auto bf = [&]() { return static_cast<const bf16*>(p[i++]); };
  auto f32 = [&]() { return static_cast<const float*>(p[i++]); };
  a.t = bf(); a.tpe = bf(); a.keys0 = bf(); a.pewq0 = bf(); a.pewq1 = bf(); a.pewk1 = bf();
  a.pewkf = bf(); a.kbd0 = bf(); a.vbd0 = bf();
  a.i0_wq = bf(); a.i0_bq = bf(); a.i0_wo = bf(); a.i0_bo = bf();
  for (Attn* s : {&a.self1, &a.t2i1, &a.i2t1, &a.fin}) {
    s->wq = bf(); s->bq = bf(); s->wk = bf(); s->bk = bf();
    s->wv = bf(); s->bv = bf(); s->wo = bf(); s->bo = bf();
  }
  a.m_w1 = bf(); a.m_b1 = bf(); a.m_w2 = bf(); a.m_b2 = bf();
  for (int k = 0; k < 6; ++k) {
    a.ln[k][0] = f32();
    a.ln[k][1] = f32();
  }
  for (int k = 0; k < 3; ++k) {
    a.h_w[k] = bf();
    a.h_b[k] = bf();
  }
  a.u_w1 = bf(); a.u_b1 = bf(); a.u_lnw = f32(); a.u_lnb = f32(); a.u_w2 = bf(); a.u_b2 = bf();
  auto out = [&]() { return const_cast<void*>(p[i++]); };
  a.tok = static_cast<bf16*>(out());
  a.masks = static_cast<float*>(out());
  a.keys1 = static_cast<bf16*>(out());
  a.keys2 = static_cast<bf16*>(out());
  a.part_o = static_cast<float*>(out());
  a.part_ml = a.part_o + static_cast<size_t>(batch) * splits * tp * kI;
  a.att = static_cast<bf16*>(out());
  a.tstate = static_cast<bf16*>(out());
  a.q_ws = static_cast<bf16*>(out());
  a.kv_ws = static_cast<bf16*>(out());
  a.hyper = static_cast<bf16*>(out());
  a.kv_self = static_cast<bf16*>(out());
  a.n = n;
  a.tp = tp;
  a.t_valid = t_valid;
  a.splits = splits;
  switch (tp) {
    case 16: return launch_tail<16>(a, batch, n, stream);
    case 32: return launch_tail<32>(a, batch, n, stream);
    case 48: return launch_tail<48>(a, batch, n, stream);
    case 64: return launch_tail<64>(a, batch, n, stream);
    default: return launch_tail<0>(a, batch, n, stream);
  }
}
