// Backward of the ViT block tail (B10), out = x1 + gelu(LN(x1) W1^T + b1)
// W2^T + b2 with x1 = x + a: from x, a and the output cotangent g, return
// dxa (the cotangent of both x and a), dscale, dbias, dW1, db1, dW2, db2.
// Replaces iuvl_tpu/ops/pallas/mlp_block.py:_tail_backward.
//
// Bound on the card: operations, 2 T C H x 5 (the recomputed hidden, dh,
// dy and the two weight gradients; 96.6 GFLOP at ViT-B 1024^2, T 4096,
// C 768, H 3072) against one read of x, a, g and the weights. The TPU
// kernel kept the (rows, 4C) hidden and its cotangent in VMEM and carried
// dW1 and dW2 across a serial grid over row chunks. Here the row chunks
// run in parallel, so the weight gradients, sums over all 4096 rows, are
// GEMMs of their own whose depth is the row dimension (gemm.cuh: a block
// owns an output tile and sums every row, no partials, no atomics), and
// the hidden and its cotangent pass through device memory (T x H bf16,
// 25 MB each, mostly L2): a first, simple version.
//   1. per row: x1, the LayerNorm statistics, y = bf16(LN(x1)).
//   2. hpre = y W1^T and dh = g W2 (tiled GEMMs, fp32 out); then per
//      element h = gelu(bf16(bf16(hpre) + b1)) and dhpre = bf16(dh gelu').
//   3. dy = dhpre W1 (GEMM); per row the LayerNorm backward, dxa =
//      bf16(g + bf16(dx1)), and dy * xhat for dscale.
//   4. dW1 = dhpre^T y, dW2 = g^T h (GEMMs over the rows); db1, db2, dscale,
//      dbias as column sums in a fixed order.
//
// Rounding points follow _tail_bwd_kernel: x1 bf16; LN statistics fp32
// with the fast variance; y = bf16(xhat * scale + bias); hpre = bf16(
// bf16(y W1^T) + b1); the tanh-GELU derivative in fp32 (the bf16 forward's
// GELU); dhpre = bf16(dh * gelu'); dy fp32; dxa = bf16(g + bf16(dx1));
// every parameter gradient fp32.
#include "gemm.cuh"

namespace iuvl {
namespace {

// tanh-GELU derivative (iuvl_tpu mlp_block._gelu_grad_f32).
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (x + a * x * x * x));
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x);
}

// One warp a row: x1 = bf16(x + a), mean and rstd (fast variance), y.
__global__ void __launch_bounds__(kThreads) tail_ln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, const float* __restrict__ scale,
    const float* __restrict__ bias, bf16* __restrict__ y, float* __restrict__ stats, int T,
    int C, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= T) return;
  const size_t base = static_cast<size_t>(row) * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = round_bf(to_f(x[base + c]) + to_f(a[base + c]));
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rstd = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);
  for (int c = lane; c < C; c += 32) {
    const float v = round_bf(to_f(x[base + c]) + to_f(a[base + c]));
    y[base + c] = to_bf((v - mu) * rstd * scale[c] + bias[c]);
  }
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = rstd;
  }
}

// h = gelu(hpre), dhpre = bf16(dh * gelu'(hpre)), hpre = bf16(bf16(p1) + b1).
__global__ void tail_gelu_kernel(const float* __restrict__ p1, const float* __restrict__ dh,
                                 const bf16* __restrict__ b1, bf16* __restrict__ h,
                                 bf16* __restrict__ dhpre, size_t total, int H) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float hp = round_bf(round_bf(p1[i]) + to_f(b1[i % H]));
  h[i] = to_bf(gelu_tanh(hp));
  dhpre[i] = to_bf(dh[i] * gelu_tanh_grad(hp));
}

// One warp a row: the LayerNorm backward; dyx = dy * xhat for dscale.
__global__ void __launch_bounds__(kThreads) tail_ln_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, const bf16* __restrict__ g,
    const float* __restrict__ scale, const float* __restrict__ stats,
    const float* __restrict__ dy, float* __restrict__ dyx, bf16* __restrict__ dxa, int T,
    int C) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= T) return;
  const size_t base = static_cast<size_t>(row) * C;
  const float mu = stats[2 * row], rstd = stats[2 * row + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (round_bf(to_f(x[base + c]) + to_f(a[base + c])) - mu) * rstd;
    const float d = dy[base + c];
    const float dys = d * scale[c];
    m1 += dys;
    m2 += dys * xhat;
    dyx[base + c] = d * xhat;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (round_bf(to_f(x[base + c]) + to_f(a[base + c])) - mu) * rstd;
    const float dx1 = rstd * (dy[base + c] * scale[c] - m1 - xhat * m2);
    dxa[base + c] = to_bf(to_f(g[base + c]) + round_bf(dx1));
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// x, a, g, dxa: (T, C) bf16; scale, bias: (C) fp32; w1: (H, C) bf16; b1: (H)
// bf16; w2t: (H, C) bf16, the second weight transposed. Scratch: yb (T, C)
// bf16; stats (T, 2) fp32; f32a, f32b (T, H) fp32; hb, dhb (T, H) bf16.
// Outputs fp32: dscale, dbias (C); dw1 (H, C); db1 (H); dw2 (C, H) in
// nn.Linear layout; db2 (C).
extern "C" int iuvl_block_tail_bwd(const void* x, const void* a, const void* g,
                                   const void* scale, const void* bias, const void* w1,
                                   const void* b1, const void* w2t, void* yb, void* stats,
                                   void* f32a, void* f32b, void* hb, void* dhb, void* dxa,
                                   void* dscale, void* dbias, void* dw1, void* db1, void* dw2,
                                   void* db2, int T, int C, int H, float eps, void* stream) {
  if (C % 128 || H % 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x_ = static_cast<const bf16*>(x);
  const bf16* a_ = static_cast<const bf16*>(a);
  const bf16* g_ = static_cast<const bf16*>(g);
  const bf16* w1_ = static_cast<const bf16*>(w1);
  const float* scale_ = static_cast<const float*>(scale);
  bf16* y_ = static_cast<bf16*>(yb);
  float* st_ = static_cast<float*>(stats);
  float* fa = static_cast<float*>(f32a);
  float* fb = static_cast<float*>(f32b);
  bf16* h_ = static_cast<bf16*>(hb);
  bf16* dh_ = static_cast<bf16*>(dhb);
  const unsigned row_blocks = (T + kWarps - 1) / kWarps;
  // 1. LayerNorm recompute
  tail_ln_kernel<<<row_blocks, kThreads, 0, s>>>(x_, a_, scale_, static_cast<const float*>(bias),
                                                 y_, st_, T, C, eps);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 2. hidden and its cotangent
  IUVL_TRY((gemm_f32<false, false>(y_, w1_, fa, T, H, C, s)));
  IUVL_TRY((gemm_f32<false, false>(g_, static_cast<const bf16*>(w2t), fb, T, H, C, s)));
  const size_t total = static_cast<size_t>(T) * H;
  tail_gelu_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      fa, fb, static_cast<const bf16*>(b1), h_, dh_, total, H);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 3. dy and the LayerNorm backward (dy in f32a, dy * xhat in f32b)
  IUVL_TRY((gemm_f32<false, true>(dh_, w1_, fa, T, C, H, s)));
  tail_ln_bwd_kernel<<<row_blocks, kThreads, 0, s>>>(x_, a_, g_, scale_, st_, fa, fb,
                                                     static_cast<bf16*>(dxa), T, C);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 4. parameter gradients
  IUVL_TRY((gemm_f32<true, true>(dh_, y_, static_cast<float*>(dw1), H, C, T, s)));
  IUVL_TRY((gemm_f32<true, true>(g_, h_, static_cast<float*>(dw2), C, H, T, s)));
  IUVL_TRY(colsum(dh_, static_cast<float*>(db1), T, H, s));
  IUVL_TRY(colsum(g_, static_cast<float*>(db2), T, C, s));
  IUVL_TRY(colsum(fb, static_cast<float*>(dscale), T, C, s));
  return colsum(fa, static_cast<float*>(dbias), T, C, s);
}
