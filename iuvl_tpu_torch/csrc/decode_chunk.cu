// SAM's whole-chunk decode tail (B16). Replaces the Pallas kernel
// decode_tail (iuvl_tpu/ops/pallas/decode_chunk.py:511, pallas_call at
// :491): for each prompt of a chunk over one shared image embedding, block
// 0's image -> token step, all of block 1 (self-attention, token -> image,
// MLP, image -> token), the final token -> image attention and its norm,
// the hypernetwork MLPs, the two 2x2/s2 deconvs with their LayerNorm2d and
// GELUs, and the mask contraction. Writes the (B, Tp, 256) bf16 tokens
// and the (B, N, 64) fp32 mask logits, columns (di, dj, ei, ej, t). Tp, the
// token slots (t_valid of them real), is a template parameter, 16 (a
// one-point prompt's 7 tokens) or 32 (up to 32 tokens: the interactive
// click loop's 26); past 32 the token passes' rows (the MLP hidden of
// Tp x 2048) no longer fit a block's shared memory. The t2i partials keep
// the online-softmax state of each 16-row token tile in registers.
//
// The TPU kernel kept a prompt's 2 MB keys row (N 4096 x C 256 bf16) in
// VMEM and ran the whole chain for one prompt per grid step, with
// block-diagonal selector matrices so that every head product was a dense
// 2-D matmul for the MXU. An SM has 228 KB of shared memory, so that design
// does not carry over. What carries over is the function's structure:
// given the prompt's token rows, every keys-side step is local to an
// image row, and only two steps reduce over the N rows (t2i1 and the final
// t2i); the hypernetwork needs the tokens after the second. So B16 is one
// C entry that launches six kernels in a fixed order on the stream:
//
//   1. tok_front   (a block a prompt): block 1's self-attention and norm1,
//                  then t2i1's queries.
//   2. row_pass<1> (8 row blocks a prompt, 32-row tiles): block 0's
//                  image -> token step (queries from the shared qp0 table),
//                  out-projection, residual, norm4 -> keys1 (written to a
//                  bf16 workspace); t2i1's k, v for the tile and a split-N
//                  online-softmax partial (max, sum, output) per head and
//                  token.
//   3. tok_mid     (a block a prompt): merge t2i1's 8 partials, out-proj,
//                  norm2, the MLP (2048), norm3; i2t1's token-side k, v and
//                  the final attention's queries.
//   4. row_pass<0>: i2t1 (q-projection of keys1 with PE, attention over the
//                  slots, out-proj, residual, norm4) -> keys2, written over
//                  keys1 in place; the final attention's k, v and partials.
//   5. tok_tail    (a block a prompt): merge, out-proj, the final norm ->
//                  tokens; the three hypernetwork layers of the 4 mask
//                  tokens (CUDA-core dot products) -> hyper (4, 32).
//   6. upscale     (64-row tiles): keys2 -> deconv1 (flat form) -> grouped
//                  LayerNorm2d -> GELU -> deconv2 per (di, dj) group -> GELU
//                  -> masks = y2 . hyper, in fp32 (B6's design).
//
// Heads are 16-wide column slices (8 of 16 in the cross attentions, 8 of
// 32 in the self-attention): a warp per head in the t2i partials, a thread
// per (row, head) over the slots in the image -> token steps; the padded
// slots (>= t_valid) are skipped where JAX adds -1e30. Products run on the
// tensor cores (wmma 16x16x16 bf16, fp32 accumulation), operands from
// shared memory and weight fragments straight from device memory (the
// weights, < 3 MB, stay in L2).
//
// Bound on the card (chip_smoke.py `work`): operations. At the chunk
// serving shape (256 prompts, N 4096) the least work is ~0.72 TFLOP
// (seven N x 256 x 128 projections a prompt, the deconvs, the attention
// products and the contraction): ~0.73 ms at 989 TFLOP/s; the bytes a
// call must move (the 268 MB of fp32 masks, the inputs once) take ~0.08
// ms. This first version moves more: keys1 and keys2 through a 512 MB
// bf16 workspace (write, read, write in place, read: 2 GB a chunk), and
// the per-prompt token passes read the MLP weights from L2 once a prompt.
//
// Rounding follows the TPU kernel: each product rounded to bf16, then its
// PE term and bias added and rounded in turn, then the residual; scores and
// softmax in fp32, probabilities rounded to bf16 before the product with v
// (the t2i partials round the unnormalised probabilities, as B4 does);
// LayerNorms in fp32 with the two-pass variance (eps 1e-5), LayerNorm2d
// with E[x^2] - E[x]^2 (eps 1e-6); tanh GELU on bf16 values; the masks
// summed and stored in fp32.
#include <initializer_list>

#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kC = 256, kI = 128, kH = 8, kHd = 16, kHs = 32, kM = 4;
constexpr int kC4 = 64, kC8 = 32, kMlp = 2048;
constexpr int kSplits = 8;      // row blocks a prompt in the two attention row passes
constexpr int kRT = 32;         // rows a tile there
constexpr int kPart = 2 + kHd;  // a softmax partial: max, sum, 16 outputs
constexpr int kLdC = kC + 8, kLdI = kI + 8, kLdM = kMlp + 8;
constexpr int kLdS = kRT + 4, kLdP = kRT + 8;
constexpr float kScaleI = 0.25f;                 // 16^-1/2
constexpr float kScaleC = 0.17677669529663687f;  // 32^-1/2
constexpr float kEps = 1e-5f, kEps2d = 1e-6f;
constexpr int kOperands = 71;  // decode_chunk.py `_operands`
static_assert(kI / kHd == kWarps && kC / kHs == kH, "a warp per head");
static_assert(kRT * kH == kThreads, "a thread per (row, head) in the slot attention");

struct Attn {
  const bf16 *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
};

enum { LN40, LN11, LN21, LN31, LN41, LNF };

struct TailArgs {  // T: the token slots, Tp
  // t, tpe (B, T, C); keys0 (N, C); qp0, pewq1, pewk1, pewkf (N, I); kbd0, vbd0 (B, T, I)
  const bf16 *t, *tpe, *keys0, *qp0, *pewq1, *pewk1, *pewkf, *kbd0, *vbd0;
  const bf16 *i0_wo, *i0_bo;
  Attn self1, t2i1, i2t1, fin;  // nn.Linear layout (out, in)
  const bf16 *m_w1, *m_b1, *m_w2, *m_b2;
  const float* ln[6][2];  // ln40, ln11, ln21, ln31, ln41, lnf: scale, bias
  const bf16 *h_w[3], *h_b[3];  // (M, out, in), (M, out)
  const bf16 *u_w1, *u_b1;
  const float *u_lnw, *u_lnb;
  const bf16 *u_w2, *u_b2;
  bf16* tok;     // (B, T, C)
  float* masks;  // (B, N, 16 M)
  bf16* keys_ws; // (B, N, C): keys1, then keys2
  float* part;   // (B, kSplits, H, T, kPart)
  bf16* tstate;  // (B, T, C): the token state between the passes
  bf16* q_ws;    // (B, T, I): t2i1's queries, then the final attention's
  bf16* kv_ws;   // (B, 2, T, I): i2t1's token-side k, v
  bf16* hyper;   // (B, M, C8)
  int n, t_valid;
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

// kRows (16 or 32) token rows A (shared, stride lda, depth k) times W^T, W
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

// Merge a prompt's kSplits softmax partials (part: (kSplits, H, T, kPart))
// into the head-merged attention output (T, I), rounded to bf16, into dst
// (shared, stride kLdI). Thread: (head, token) pairs tid / 2 + 128 j, half
// tid % 2 of the 16 outputs.
template <int kT>
__device__ void merge_partials(const float* part, bf16* dst) {
  const int half = threadIdx.x & 1;
  for (int pair = threadIdx.x >> 1; pair < kH * kT; pair += kThreads / 2) {
    const int h = pair / kT, t = pair % kT;
    const float* p = part + static_cast<size_t>(pair) * kPart;
    constexpr int stride = kH * kT * kPart;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kSplits; ++j) mx = fmaxf(mx, p[j * stride]);
    float l = 0.f, o[8] = {};
#pragma unroll
    for (int j = 0; j < kSplits; ++j) {
      const float* q = p + j * stride;
      const float e = expf(q[0] - mx);
      l += q[1] * e;
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] += q[2 + half * 8 + k] * e;
    }
    const float lf = fmaxf(l, 1e-30f);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] /= lf;
    store8(dst + t * kLdI + h * kHd + half * 8, o);
  }
}

// -------------------------------------------------------------- tok_front --
template <int kT>
constexpr size_t kFrontSmem = 7 * kT * kLdC * sizeof(bf16) + kWarps * 256 * sizeof(float);

template <int kT>
__global__ void __launch_bounds__(kThreads) tok_front_kernel(TailArgs a) {
  static_assert(kT * kH <= kThreads, "a thread per (slot, head) in the self-attention");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT = reinterpret_cast<bf16*>(smem);  // t
  bf16* sE = sT + kT * kLdC;                 // tpe
  bf16* sU = sE + kT * kLdC;                 // t + tpe, then t1 + tpe
  bf16* sQ = sU + kT * kLdC;                 // self-attention q, then its output
  bf16* sK = sQ + kT * kLdC;
  bf16* sV = sK + kT * kLdC;
  bf16* sY = sV + kT * kLdC;  // residual sum, then t1
  float* st = reinterpret_cast<float*>(sY + kT * kLdC) + (threadIdx.x >> 5) * 256;
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
  if (tid < kT * kH) {  // (query, head): attention over the valid slots, into sQ
    const int q = tid >> 3, h = tid & 7;
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
  add_rows<kT>(sU, sY, sE);
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

// ---------------------------------------------------------------- tok_mid --
template <int kT>
constexpr size_t kMidSmem = (4 * kT * kLdC + kT * kLdI + kT * kLdM) * sizeof(bf16) +
                            kWarps * 256 * sizeof(float);

template <int kT>
__global__ void __launch_bounds__(kThreads) tok_mid_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT1 = reinterpret_cast<bf16*>(smem);  // t1
  bf16* sE = sT1 + kT * kLdC;                 // tpe
  bf16* sU = sE + kT * kLdC;                  // t1 + tpe
  bf16* sY = sU + kT * kLdC;                  // residual sums
  bf16* sA = sY + kT * kLdC;                  // merged attention output
  bf16* sH = sA + kT * kLdI;                  // the MLP's hidden
  float* st = reinterpret_cast<float*>(sH + kT * kLdM) + (threadIdx.x >> 5) * 256;
  const int b = blockIdx.x;
  stage_rows(sT1, kLdC, a.tstate + static_cast<size_t>(b) * kT * kC, kC, kT, kC);
  stage_rows(sE, kLdC, a.tpe + static_cast<size_t>(b) * kT * kC, kC, kT, kC);
  cp_async_commit();
  merge_partials<kT>(a.part + static_cast<size_t>(b) * kSplits * kH * kT * kPart, sA);
  cp_async_wait<0>();
  __syncthreads();
  tok_gemm<kT>(sA, kLdI, kI, a.t2i1.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.t2i1.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sT1, kLdC, kT, a.ln[LN21][0], a.ln[LN21][1], nullptr);
  __syncthreads();
  tok_gemm<kT>(sT1, kLdC, kC, a.m_w1, kMlp, st, [&](int r, int c, const float* v) {
    const uint4 bv = load8(a.m_b1 + c);
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = fmaxf(round_bf(v[j]) + at8(bv, j), 0.f);
    store8(sH + r * kLdM + c, o);
  });
  __syncthreads();
  tok_gemm<kT>(sH, kLdM, kMlp, a.m_w2, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.m_b2 + c);
  });
  __syncthreads();
  ln_rows(sY, sT1, kLdC, kT, a.ln[LN31][0], a.ln[LN31][1],
          a.tstate + static_cast<size_t>(b) * kT * kC);
  __syncthreads();
  add_rows<kT>(sU, sT1, sE);
  __syncthreads();
  bf16* kv = a.kv_ws + static_cast<size_t>(b) * 2 * kT * kI;
  tok_gemm<kT>(sU, kLdC, kC, a.i2t1.wk, kI, st, [&](int r, int c, const float* v) {
    store_biased(kv + r * kI + c, v, a.i2t1.bk + c);
  });
  tok_gemm<kT>(sT1, kLdC, kC, a.i2t1.wv, kI, st, [&](int r, int c, const float* v) {
    store_biased(kv + (kT + r) * kI + c, v, a.i2t1.bv + c);
  });
  bf16* qf = a.q_ws + static_cast<size_t>(b) * kT * kI;
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

template <int kT>
__global__ void __launch_bounds__(kThreads) tok_tail_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sT1 = reinterpret_cast<bf16*>(smem);
  bf16* sY = sT1 + kT * kLdC;
  bf16* sA = sY + kT * kLdC;
  float* hx = reinterpret_cast<float*>(sA + kT * kLdI);  // kM x kC
  float* hy = hx + kM * kC;
  float* st = hy + kM * kC + (threadIdx.x >> 5) * 256;
  const int b = blockIdx.x;
  stage_rows(sT1, kLdC, a.tstate + static_cast<size_t>(b) * kT * kC, kC, kT, kC);
  cp_async_commit();
  merge_partials<kT>(a.part + static_cast<size_t>(b) * kSplits * kH * kT * kPart, sA);
  cp_async_wait<0>();
  __syncthreads();
  tok_gemm<kT>(sA, kLdI, kI, a.fin.wo, kC, st, [&](int r, int c, const float* v) {
    store_residual(sY + r * kLdC + c, sT1 + r * kLdC + c, v, a.fin.bo + c);
  });
  __syncthreads();
  ln_rows(sY, sY, kLdC, kT, a.ln[LNF][0], a.ln[LNF][1], a.tok + static_cast<size_t>(b) * kT * kC);
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

// --------------------------------------------------------------- row_pass --
template <int kT>
constexpr size_t kRowSmem =
    (2 * kRT * kLdC + 4 * kRT * kLdI + kT * kLdI + 2 * kT * kI) * sizeof(bf16) +
    kWarps * kT * kLdS * sizeof(float) + kWarps * kT * kLdP * sizeof(bf16);

// kFirst: block 0's image -> token step over the shared keys0 (queries from
// the qp0 table), then t2i1's partials. Otherwise: i2t1 over keys1 (the
// q-projection here), then the final attention's partials.
template <int kT, bool kFirst>
__global__ void __launch_bounds__(kThreads) row_pass_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);  // input rows
  bf16* sY = sX + kRT * kLdC;                // output rows (keys1 / keys2)
  bf16* sQ = sY + kRT * kLdC;                // the rows' queries
  bf16* sA = sQ + kRT * kLdI;                // their attention output
  bf16* sK = sA + kRT * kLdI;                // t2i keys, values of the tile
  bf16* sV = sK + kRT * kLdI;
  bf16* sQt = sV + kRT * kLdI;               // the prompt's t2i queries (T x I)
  bf16* sKV = sQt + kT * kLdI;               // the prompt's slot keys, values (2 x T x I)
  float* sS = reinterpret_cast<float*>(sKV + 2 * kT * kI);
  bf16* sP = reinterpret_cast<bf16*>(sS + kWarps * kT * kLdS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y;
  const int rows = a.n / kSplits, row0 = split * rows;
  const size_t base = static_cast<size_t>(b) * a.n * kC;
  const bf16* X = kFirst ? a.keys0 : a.keys_ws + base;
  bf16* Y = a.keys_ws + base;
  const bf16* tk = kFirst ? a.kbd0 + static_cast<size_t>(b) * kT * kI
                          : a.kv_ws + static_cast<size_t>(b) * 2 * kT * kI;
  const bf16* tv = kFirst ? a.vbd0 + static_cast<size_t>(b) * kT * kI : tk + kT * kI;
  const bf16* wo = kFirst ? a.i0_wo : a.i2t1.wo;
  const bf16* bo = kFirst ? a.i0_bo : a.i2t1.bo;
  const float* lnw = a.ln[kFirst ? LN40 : LN41][0];
  const float* lnb = a.ln[kFirst ? LN40 : LN41][1];
  const Attn& wt = kFirst ? a.t2i1 : a.fin;
  const bf16* pe_k = kFirst ? a.pewk1 : a.pewkf;

  stage_rows(sKV, kI, tk, kI, kT, kI);
  stage_rows(sKV + kT * kI, kI, tv, kI, kT, kI);
  stage_rows(sQt, kLdI, a.q_ws + static_cast<size_t>(b) * kT * kI, kI, kT, kI);
  cp_async_commit();

  // In an epilogue a lane owns row er, columns ec..ec+7 of a 16x16 tile. A
  // warp's products cover its column tiles in both 16-row halves of the
  // tile, so each weight fragment is read from L2 once a tile.
  const int er = lane >> 1, ec = (lane & 1) * 8;
  const int row = lane >> 1, half = lane & 1;  // t2i: token row of a tile, half of the keys
  constexpr int kTT = kT / 16;                 // 16-row token tiles
  float m[kTT], l[kTT], acc[kTT][8];
#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) {
    m[tt] = kNegInf;
    l[tt] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[tt][j] = 0.f;
  }
  float* S = sS + warp * kT * kLdS;  // also the warp's 16x16 staging tile
  bf16* P = sP + warp * kT * kLdP;
  auto staged = [&](const FragC& f, float v[8]) {
    wmma::store_matrix_sync(S, f, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = S[er * 16 + ec + j];
    __syncwarp();
  };

  for (int r0 = row0; r0 < row0 + rows; r0 += kRT) {
    stage_rows(sX, kLdC, X + static_cast<size_t>(r0) * kC, kC, kRT, kC);
    if (kFirst) stage_rows(sQ, kLdI, a.qp0 + static_cast<size_t>(r0) * kI, kI, kRT, kI);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    if (!kFirst) {  // qp = x @ Wq^T + pe_wq + bq: column tile w, both row tiles
      FragC qc[2];
      wmma::fill_fragment(qc[0], 0.f);
      wmma::fill_fragment(qc[1], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < kC; kk += 16) {
        FragBc fb;
        wmma::load_matrix_sync(fb, a.i2t1.wq + warp * 16 * kC + kk, kC);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          FragA fa;
          wmma::load_matrix_sync(fa, sX + r * 16 * kLdC + kk, kLdC);
          wmma::mma_sync(qc[r], fa, fb, qc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[8];
        staged(qc[r], v);
        const int row_ = r * 16 + er, c = warp * 16 + ec;
        const uint4 pe = load8(a.pewq1 + static_cast<size_t>(r0 + row_) * kI + c);
        const uint4 bq = load8(a.i2t1.bq + c);
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = round_bf(round_bf(v[j]) + at8(pe, j)) + at8(bq, j);
        store8(sQ + row_ * kLdI + c, o);
      }
      __syncthreads();
    }

    {  // attention of (row, head) = (tid / 8, tid % 8) over the valid slots
      const int r = tid >> 3, h = tid & 7;
      float qv[kHd];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 x = load8(sQ + r * kLdI + h * kHd + u * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[u * 8 + j] = at8(x, j);
      }
      float s[kT], mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < a.t_valid) {
          const uint4 k0 = load8(sKV + t * kI + h * kHd), k1 = load8(sKV + t * kI + h * kHd + 8);
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < 8; ++d) dot += qv[d] * at8(k0, d);
#pragma unroll
          for (int d = 0; d < 8; ++d) dot += qv[8 + d] * at8(k1, d);
          s[t] = dot * kScaleI;
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
      float o[kHd] = {};
      const bf16* vt = sKV + kT * kI;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        if (t < a.t_valid) {
          const float p = round_bf(s[t] / den);
          const uint4 v0 = load8(vt + t * kI + h * kHd), v1 = load8(vt + t * kI + h * kHd + 8);
#pragma unroll
          for (int d = 0; d < 8; ++d) o[d] += p * at8(v0, d);
#pragma unroll
          for (int d = 0; d < 8; ++d) o[8 + d] += p * at8(v1, d);
        }
      }
      store8(sA + r * kLdI + h * kHd, o);
      store8(sA + r * kLdI + h * kHd + 8, o + 8);
    }
    __syncthreads();

    {  // y = x + (att @ Wo^T) + bo -> sY: column tiles 2w, 2w + 1, both row tiles
      const int ct = warp * 2;
      FragC oc[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u) wmma::fill_fragment(oc[r][u], 0.f);
#pragma unroll
      for (int kk = 0; kk < kI; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) wmma::load_matrix_sync(fa[r], sA + r * 16 * kLdI + kk, kLdI);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragBc fb;
          wmma::load_matrix_sync(fb, wo + (ct + u) * 16 * kI + kk, kI);
#pragma unroll
          for (int r = 0; r < 2; ++r) wmma::mma_sync(oc[r][u], fa[r], fb, oc[r][u]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[8];
          staged(oc[r][u], v);
          const int off = (r * 16 + er) * kLdC + (ct + u) * 16 + ec;
          store_residual(sY + off, sX + off, v, bo + (ct + u) * 16 + ec);
        }
    }
    __syncthreads();
    ln_rows(sY, sY, kLdC, kRT, lnw, lnb, Y + static_cast<size_t>(r0) * kC);
    __syncthreads();

    {  // kp = y @ Wk^T + pe_wk + bk (warps 0-3), vp = y @ Wv^T + bv (4-7):
       // column tiles 2w, 2w + 1 of [kp | vp], both row tiles
      const int ct = warp * 2;
      const bool is_k = ct < kI / 16;
      const bf16* w = is_k ? wt.wk + ct * 16 * kC : wt.wv + (ct - kI / 16) * 16 * kC;
      FragC pc[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u) wmma::fill_fragment(pc[r][u], 0.f);
#pragma unroll 4
      for (int kk = 0; kk < kC; kk += 16) {
        FragA fa[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) wmma::load_matrix_sync(fa[r], sY + r * 16 * kLdC + kk, kLdC);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragBc fb;
          wmma::load_matrix_sync(fb, w + u * 16 * kC + kk, kC);
#pragma unroll
          for (int r = 0; r < 2; ++r) wmma::mma_sync(pc[r][u], fa[r], fb, pc[r][u]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v[8];
          staged(pc[r][u], v);
          const int row_ = r * 16 + er, c = (ct + u) * 16 + ec - (is_k ? 0 : kI);
          if (is_k) {
            const uint4 pe = load8(pe_k + static_cast<size_t>(r0 + row_) * kI + c);
            const uint4 bk = load8(wt.bk + c);
            float o[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) o[j] = round_bf(round_bf(v[j]) + at8(pe, j)) + at8(bk, j);
            store8(sK + row_ * kLdI + c, o);
          } else {
            store_biased(sV + row_ * kLdI + c, v, wt.bv + c);
          }
        }
    }
    __syncthreads();

#pragma unroll
    for (int tt = 0; tt < kTT; ++tt) {  // the t2i online softmax of head `warp`:
      FragA qa;                         // token tile tt's 16 rows x 32 keys
      wmma::load_matrix_sync(qa, sQt + tt * 16 * kLdI + warp * kHd, kLdI);
#pragma unroll
      for (int u = 0; u < kRT / 16; ++u) {
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
      for (int kk = 0; kk < kRT; kk += 16) {
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
    __syncthreads();  // every tile buffer is free
  }

#pragma unroll
  for (int tt = 0; tt < kTT; ++tt) {
    float* out = a.part + ((((static_cast<size_t>(b) * kSplits + split) * kH + warp) * kT +
                            tt * 16 + row) * kPart);
    if (half == 0) {
      out[0] = m[tt];
      out[1] = l[tt];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) out[2 + half * 8 + j] = acc[tt][j];
  }
}

// ---------------------------------------------------------------- upscale --
constexpr int kUpRows = 64;
constexpr int kW1Cols = 4 * kC4;   // 256, cols (di, dj, co)
constexpr int kW2Cols = 4 * kC8;   // 128, cols (ei, ej, co)
constexpr int kOutCols = 16 * kM;  // 64, cols (di, dj, ei, ej, t)
constexpr int kLd1 = kW1Cols + 8, kLd2 = kW2Cols + 8;
constexpr size_t kUpSmem = kUpRows * (kLdC + kLd1 + kLd2) * sizeof(bf16) +
                           (kUpRows * kOutCols + kWarps * 256 + kM * kC8) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2) upscale_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kUpRows x kLdC
  bf16* y1b = xs + kUpRows * kLdC;           // kUpRows x kLd1
  bf16* y2b = y1b + kUpRows * kLd1;          // kUpRows x kLd2
  float* outs = reinterpret_cast<float*>(y2b + kUpRows * kLd2);  // kUpRows x kOutCols
  float* st = outs + kUpRows * kOutCols + (threadIdx.x >> 5) * 256;
  float* hyp = outs + kUpRows * kOutCols + kWarps * 256;  // kM x kC8

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * a.n + static_cast<size_t>(blockIdx.x) * kUpRows;
  stage_rows(xs, kLdC, a.keys_ws + row0 * kC, kC, kUpRows, kC);
  cp_async_commit();
  if (tid < kM * kC8) hyp[tid] = to_f(a.hyper[static_cast<size_t>(b) * kM * kC8 + tid]);
  const int er = lane >> 1, ec = (lane & 1) * 8;
  uint4 b1v[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) b1v[u] = load8(a.u_b1 + (warp * 32 + u * 16 + ec) % kC4);
  const uint4 b2v = load8(a.u_b2 + (warp * 16 + ec) % kC8);
  cp_async_wait<0>();
  __syncthreads();

  auto staged = [&](const FragC& f, float v[8]) {
    wmma::store_matrix_sync(st, f, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = st[er * 16 + ec + j];
    __syncwarp();
  };

  // y1 = x @ W1 + b1: 4 row tiles x 16 col tiles; warp owns col tiles 2w, 2w+1.
  {
    FragC acc[4][2];
#pragma unroll
    for (int rtile = 0; rtile < 4; ++rtile) {
      wmma::fill_fragment(acc[rtile][0], 0.f);
      wmma::fill_fragment(acc[rtile][1], 0.f);
    }
    for (int k = 0; k < kC; k += 16) {
      FragBr fb0, fb1;  // B[k][n] = W1[k][n]
      wmma::load_matrix_sync(fb0, a.u_w1 + k * kW1Cols + warp * 32, kW1Cols);
      wmma::load_matrix_sync(fb1, a.u_w1 + k * kW1Cols + warp * 32 + 16, kW1Cols);
#pragma unroll
      for (int rtile = 0; rtile < 4; ++rtile) {
        FragA fa;
        wmma::load_matrix_sync(fa, xs + rtile * 16 * kLdC + k, kLdC);
        wmma::mma_sync(acc[rtile][0], fa, fb0, acc[rtile][0]);
        wmma::mma_sync(acc[rtile][1], fa, fb1, acc[rtile][1]);
      }
    }
#pragma unroll
    for (int rtile = 0; rtile < 4; ++rtile) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v[8], o[8];
        staged(acc[rtile][u], v);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = round_bf(v[j]) + at8(b1v[u], j);
        store8(y1b + (rtile * 16 + er) * kLd1 + warp * 32 + u * 16 + ec, o);
      }
    }
  }
  __syncthreads();

  // grouped LayerNorm2d and GELU in place: 8 lanes a (row, group).
  const int gc = (lane & 7) * 8;
  float lw[8], lb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lw[j] = a.u_lnw[gc + j];
    lb[j] = a.u_lnb[gc + j];
  }
  for (int pair = warp * 4 + (lane >> 3); pair < kUpRows * 4; pair += kWarps * 4) {
    bf16* rowp = y1b + (pair >> 2) * kLd1 + (pair & 3) * kC4 + gc;
    const uint4 raw = load8(rowp);
    float v[8], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = at8(raw, j);
      s += v[j];
      s2 += v[j] * v[j];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / kC4;
    const float rstd = rsqrtf(s2 / kC4 - mean * mean + kEps2d);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gelu_tanh(round_bf((v[j] - mean) * rstd * lw[j] + lb[j]));
    store8(rowp, v);
  }
  __syncthreads();

  for (int g = 0; g < 4; ++g) {  // (di, dj) group: y2_g = gelu(y1_g @ W2 + b2)
    FragC acc[4];
#pragma unroll
    for (int rtile = 0; rtile < 4; ++rtile) wmma::fill_fragment(acc[rtile], 0.f);
#pragma unroll
    for (int kk = 0; kk < kC4; kk += 16) {
      FragBr fb;
      wmma::load_matrix_sync(fb, a.u_w2 + kk * kW2Cols + warp * 16, kW2Cols);
#pragma unroll
      for (int rtile = 0; rtile < 4; ++rtile) {
        FragA fa;
        wmma::load_matrix_sync(fa, y1b + rtile * 16 * kLd1 + g * kC4 + kk, kLd1);
        wmma::mma_sync(acc[rtile], fa, fb, acc[rtile]);
      }
    }
#pragma unroll
    for (int rtile = 0; rtile < 4; ++rtile) {
      float v[8];
      staged(acc[rtile], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gelu_tanh(round_bf(round_bf(v[j]) + at8(b2v, j)));
      store8(y2b + (rtile * 16 + er) * kLd2 + warp * 16 + ec, v);
    }
    __syncthreads();
    // masks[r, g, e, t] = sum_c y2[r, e, c] * hyper[t, c]
    for (int i = tid; i < kUpRows * 16; i += kThreads) {
      const int r = i >> 4, e = (i >> 2) & 3, t = i & 3;
      const bf16* yv = y2b + r * kLd2 + e * kC8;
      const float* hv = hyp + t * kC8;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kC8; c += 8) {
        const uint4 y8 = load8(yv + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += at8(y8, j) * hv[c + j];
      }
      outs[r * kOutCols + g * 16 + e * 4 + t] = s;
    }
    __syncthreads();
  }

  float4* o = reinterpret_cast<float4*>(a.masks + row0 * kOutCols);
  const float4* src = reinterpret_cast<const float4*>(outs);
  for (int i = tid; i < kUpRows * kOutCols / 4; i += kThreads) o[i] = src[i];
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

namespace {

template <int kT>
int launch_tail(const TailArgs& a, int batch, int n, void* stream) {
  int err = launch_kernel(tok_front_kernel<kT>, dim3(batch), kFrontSmem<kT>, stream, a);
  if (!err)
    err = launch_kernel(row_pass_kernel<kT, true>, dim3(kSplits, batch), kRowSmem<kT>, stream, a);
  if (!err) err = launch_kernel(tok_mid_kernel<kT>, dim3(batch), kMidSmem<kT>, stream, a);
  if (!err)
    err = launch_kernel(row_pass_kernel<kT, false>, dim3(kSplits, batch), kRowSmem<kT>, stream, a);
  if (!err) err = launch_kernel(tok_tail_kernel<kT>, dim3(batch), kTailSmem<kT>, stream, a);
  if (!err) err = launch_kernel(upscale_kernel, dim3(n / kUpRows, batch), kUpSmem, stream, a);
  return err;
}

}  // namespace

// p: kOperands pointers in the order of iuvl_tpu_torch/ops/cuda/decode_chunk.py
// `_operands` (inputs, precomputes, weights), then tokens_out, masks and
// the six workspace buffers. tp (the token slots) 16 or 32, 1 <= t_valid <=
// tp, N % 256 == 0.
extern "C" int iuvl_decode_tail(const void* const* p, int count, int batch, int n, int tp,
                                int t_valid, void* stream) {
  if (count != kOperands + 8 || (tp != 16 && tp != 32) || t_valid < 1 || t_valid > tp ||
      n % (kSplits * kRT) || n % kUpRows || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a;
  int i = 0;
  auto bf = [&]() { return static_cast<const bf16*>(p[i++]); };
  auto f32 = [&]() { return static_cast<const float*>(p[i++]); };
  a.t = bf(); a.tpe = bf(); a.keys0 = bf(); a.qp0 = bf(); a.pewq1 = bf(); a.pewk1 = bf();
  a.pewkf = bf(); a.kbd0 = bf(); a.vbd0 = bf();
  a.i0_wo = bf(); a.i0_bo = bf();
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
  a.keys_ws = static_cast<bf16*>(out());
  a.part = static_cast<float*>(out());
  a.tstate = static_cast<bf16*>(out());
  a.q_ws = static_cast<bf16*>(out());
  a.kv_ws = static_cast<bf16*>(out());
  a.hyper = static_cast<bf16*>(out());
  a.n = n;
  a.t_valid = t_valid;
  return tp == 16 ? launch_tail<16>(a, batch, n, stream) : launch_tail<32>(a, batch, n, stream);
}
