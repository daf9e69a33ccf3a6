// Backward of the ViT block tail (B10), out = x1 + gelu(LN(x1) W1^T + b1)
// W2^T + b2 with x1 = x + a: from x, a and the output cotangent g, return
// dxa (the cotangent of both x and a), dscale, dbias, dW1, db1, dW2, db2.
// Replaces iuvl_tpu/ops/pallas/mlp_block.py:_tail_backward.
//
// Bound on the card: operations, 2 T C H x 5 (the recomputed hidden, dh,
// dy and the two weight gradients; 96.6 GFLOP at ViT-B 1024^2, T 4096,
// C 768, H 3072, 0.098 ms at 989 TFLOP/s) against one read of x, a, g and
// the weights. The TPU kernel kept the (rows, 4C) hidden and its cotangent
// in VMEM and carried dW1 and dW2 across a serial grid over row chunks.
// Here the row chunks run in parallel and every product is the wgmma GEMM
// of linear_wgmma.cuh, its epilogue doing the element-wise work:
//   1. tail_ln_kernel, a warp a row: x1, the LayerNorm statistics, y =
//      bf16(LN(x1)) (each lane sums columns lane + 32 i in order).
//   2. hpre = bf16(bf16(y W1^T) + b1) (kEpiHidden, (T, H) bf16); dh = g W2
//      (B = w2t, K-major), whose epilogue stages the hpre tile through
//      shared memory and writes h = bf16(gelu(hpre)) and dhpre = bf16(dh
//      gelu'(hpre)) with dh straight from the fp32 accumulator
//      (kEpiGeluBwd): no (T, H) fp32 array.
//   3. dy = dhpre W1 (W1 (H, C) read N-major; fp32 out, into hpre's bytes);
//      tail_ln_bwd_kernel, a warp a row: dxa = bf16(g + bf16(dx1)) and dy
//      xhat for dscale.
//   4. dW1 = dhpre^T y and dW2 = g^T h: the token rows are the depth, both
//      operands read M-/N-major; split-K over the rows in thread block
//      clusters, the splits' tiles added in split order through
//      distributed shared memory (linear_wgmma.cuh), so two launches give
//      the same bits.
//   5. db1, db2, dscale, dbias: column sums in a fixed order, two launches
//      for the four (colsums).
// Measured (ptxas on the card): the GEMMs 110-128 registers and 99,328
// bytes a block (the dh GEMM spills 8 bytes), the row passes 32 registers.
// On the card (H100 SXM, 700 W; tools/kernel_ab.py, PERF.md §6)
// 0.367 ms at ViT-B 1024^2 (the earlier wmma design: 1.198): LayerNorm 0.011,
// hidden 0.055, dh with h and dhpre 0.063 (0.126 with the epilogue's
// loads and stores straight from registers), dy 0.052, LayerNorm backward
// 0.024, dW1 and dW2 0.061 each (two splits), column sums 0.027; batch 2
// 0.664, ViT-H 0.791, T 2500 0.257.
//
// Rounding points follow _tail_bwd_kernel: x1 bf16; LN statistics fp32
// with the fast variance; y = bf16(xhat * scale + bias); hpre = bf16(
// bf16(y W1^T) + b1); the tanh-GELU derivative in fp32 (the bf16 forward's
// GELU); dhpre = bf16(dh * gelu'); dy fp32; dxa = bf16(g + bf16(dx1));
// every parameter gradient fp32.
#include "linear_wgmma.cuh"

namespace iuvl {
namespace {

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
// bf16; stats (T, 2) fp32; hpre (T, max(H, 4 C)) bf16 (dy and dy * xhat,
// (T, C) fp32 each, later take its bytes); hb, dhb (T, H) bf16; sums, the
// column sums' chunks (ops/cuda/build.py colsum_scratch(T, max(H, C), 4))
// fp32. Outputs fp32: dscale, dbias (C); dw1 (H, C); db1 (H); dw2 (C, H) in
// nn.Linear layout; db2 (C). splits: the weight gradients' split-K (1, 2, 4
// or 8; split_k in ops/cuda/build.py). C % 8 == 0, H % 8 == 0.
extern "C" int iuvl_block_tail_bwd(const void* x, const void* a, const void* g,
                                   const void* scale, const void* bias, const void* w1,
                                   const void* b1, const void* w2t, void* yb, void* stats,
                                   void* hpre, void* hb, void* dhb, void* sums, void* dxa,
                                   void* dscale, void* dbias, void* dw1, void* db1, void* dw2,
                                   void* db2,
                                   int T, int C, int H, int splits, float eps, void* stream) {
  if (T < 1 || C % 8 || H % 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x_ = static_cast<const bf16*>(x);
  const bf16* a_ = static_cast<const bf16*>(a);
  const bf16* g_ = static_cast<const bf16*>(g);
  const bf16* w1_ = static_cast<const bf16*>(w1);
  const float* scale_ = static_cast<const float*>(scale);
  bf16* y_ = static_cast<bf16*>(yb);
  float* st_ = static_cast<float*>(stats);
  bf16* hp_ = static_cast<bf16*>(hpre);
  bf16* h_ = static_cast<bf16*>(hb);
  bf16* dh_ = static_cast<bf16*>(dhb);
  float* dy_ = reinterpret_cast<float*>(hp_);  // hpre is dead once h and dhpre are out
  float* dyx_ = dy_ + static_cast<size_t>(T) * C;
  const unsigned row_blocks = (T + kWarps - 1) / kWarps;
  // 1. LayerNorm recompute
  tail_ln_kernel<<<row_blocks, kThreads, 0, s>>>(x_, a_, scale_, static_cast<const float*>(bias),
                                                 y_, st_, T, C, eps);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 2. hpre = bf16(bf16(y W1^T) + b1); dh = g W2 with h and dhpre from hpre
  LinearParams p{y_, w1_, b1, hp_, T, H, C, 0, 0, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY(linear_gemm<kEpiHidden>(p, s));
  p = LinearParams{g_, static_cast<const bf16*>(w2t), nullptr, h_, T, H, C, 0, 0, 0, 0, hp_,
                   nullptr, dh_, 0};
  IUVL_TRY(linear_gemm<kEpiGeluBwd>(p, s));
  // 3. dy = dhpre W1 (W1 read N-major) and the LayerNorm backward
  p = LinearParams{dh_, w1_, nullptr, dy_, T, C, H, 0, C, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiF32, kRowK, kMn>(p, s)));
  tail_ln_bwd_kernel<<<row_blocks, kThreads, 0, s>>>(x_, a_, g_, scale_, st_, dy_, dyx_,
                                                     static_cast<bf16*>(dxa), T, C);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 4. dW1 = dhpre^T y, dW2 = g^T h: the token rows are the depth, both
  // operands read M-/N-major, split-K in clusters
  p = LinearParams{dh_, y_, nullptr, dw1, H, C, T, H, C, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiF32, kMn, kMn>(p, s, splits)));
  p = LinearParams{g_, h_, nullptr, dw2, C, H, T, C, H, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiF32, kMn, kMn>(p, s, splits)));
  // 5. bias, LayerNorm scale and bias gradients: column sums in a fixed order
  ColsumJobs jobs{{{dh_, static_cast<float*>(db1), H, 0},
                   {g_, static_cast<float*>(db2), C, 0},
                   {dyx_, static_cast<float*>(dscale), C, 1},
                   {dy_, static_cast<float*>(dbias), C, 1}}};
  return colsums(jobs, 4, T, static_cast<float*>(sums), s);
}
