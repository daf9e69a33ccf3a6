// ViT block tail: out = x1 + gelu(LN(x1) @ W1^T + b1) @ W2^T + b2, x1 = x
// + a. Replaces iuvl_tpu/ops/pallas/mlp_block.py:block_tail (B3).
//
// Bound on the card: 2*T*C*4C*2 FLOPs (38.7 GFLOP for ViT-B at 1024^2,
// 0.039 ms at 989 TFLOP/s) on the tensor cores, against one read of x, a
// and the weights and one write of out (~32 MB, 0.01 ms).
//
// The TPU kernel kept a row block's (rows, 4C) hidden and both weight
// matrices in VMEM. An SM cannot hold both matrices (9.4 MB at ViT-B), and
// a block that streams them for its own rows reads them from L2 once a
// block (the first design: 32-row blocks on wmma, ~1.2 GB of L2 reads a
// call, 0.467 ms, slower than its plain version). So the tail runs as
// three launches behind one C entry:
//   1. tail_ln_kernel (a warp a row): x1 = bf16(x + a), LayerNorm in fp32
//      with the fast variance max(E[x^2] - E[x]^2, 0) -> y (T, C) bf16,
//      its sums in the first kernel's order.
//   2. linear_wgmma (linear_wgmma.cuh, kEpiGelu): h = gelu(bf16(bf16(y
//      W1^T) + b1)) -> (T, 4C) bf16, 128 x 128 tiles on wgmma.
//   3. linear_wgmma (kEpiResid): out = bf16(x + a) + bf16(bf16(h W2^T) +
//      b2), the residual read back from x and a.
// The bf16 hidden makes one round trip (25 MB at ViT-B, mostly in L2);
// each GEMM reads a weight tile from L2 once a 128-row tile. Any T (the
// GEMMs' last row tile is masked), C in {768, 1024, 1280}, H % 128 == 0.
// No atomics: two launches give the same bits. On the card (H100 SXM, 700
// W; tools/kernel_ab.py, PERF.md §6) 0.126 ms at ViT-B 1024^2 (the
// LayerNorm 0.006, the GEMMs 0.058 and 0.054), 0.276 at ViT-H.
//
// Rounding points follow _tail_xla: residual add in bf16; LN in fp32 with
// the fast variance; the product rounded to bf16 before +b1 and the add
// rounded; tanh GELU on that bf16 value; the MLP output rounded before
// +b2; the residual add rounded.
#include "linear_wgmma.cuh"

namespace iuvl {
namespace {

// y = bf16(LN(bf16(x + a))) of T rows of C = 256 NV, a warp a row: lane l
// holds columns l + 32 i, and sums them in that order: the order of B3's
// first kernel, whose bits the train gates were found to read (PERF.md §6).
template <int NV>
__global__ void __launch_bounds__(256) tail_ln_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a, const float* __restrict__ scale,
    const float* __restrict__ bias, bf16* __restrict__ y, int T, float eps) {
  constexpr int C = NV * 256, kPer = C / 32;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= T) return;
  const size_t base = static_cast<size_t>(row) * C + lane;
  float v[kPer], s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    v[i] = to_f(__hadd(x[base + 32 * i], a[base + 32 * i]));
    s += v[i];
    s2 += v[i] * v[i];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C;
  const float rstd = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
    y[base + 32 * i] = to_bf((v[i] - mu) * (rstd * scale[c]) + bias[c]);
  }
}

template <int NV>
int launch_ln(const bf16* x, const bf16* a, const float* scale, const float* bias, bf16* y,
              int T, float eps, cudaStream_t s) {
  tail_ln_kernel<NV><<<(T + 7) / 8, 256, 0, s>>>(x, a, scale, bias, y, T, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// x, a, out: (T, C) bf16; scale, bias: (C) fp32; w1: (H, C) bf16; b1: (H)
// bf16; w2: (C, H) bf16 (nn.Linear layout); b2: (C) bf16. Scratch from the
// wrapper: y (T, C) and h (T, H) bf16. Any T, C in {768, 1024, 1280}, H %
// 128 == 0.
extern "C" int iuvl_block_tail(const void* x, const void* a, const void* scale,
                               const void* bias, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out, void* y, void* h,
                               int T, int C, int H, float eps, void* stream) {
  if (T < 1 || H < 128 || H % 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto *xb = static_cast<const bf16*>(x), *ab = static_cast<const bf16*>(a);
  const auto *sc = static_cast<const float*>(scale), *bi = static_cast<const float*>(bias);
  auto* yb = static_cast<bf16*>(y);
  auto* hb = static_cast<bf16*>(h);
  int err;
  switch (C) {
    case 768: err = launch_ln<3>(xb, ab, sc, bi, yb, T, eps, s); break;
    case 1024: err = launch_ln<4>(xb, ab, sc, bi, yb, T, eps, s); break;
    case 1280: err = launch_ln<5>(xb, ab, sc, bi, yb, T, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!err)
    err = linear_wgmma<kEpiGelu>(yb, static_cast<const bf16*>(w1), b1, hb, T, H, C, 0, 0, s);
  if (!err)
    err = linear_wgmma<kEpiResid>(hb, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out),
                                  T, C, H, 0, 0, s, xb, ab);
  return err;
}

extern "C" const char* iuvl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
