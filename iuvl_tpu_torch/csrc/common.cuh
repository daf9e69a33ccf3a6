// Shared helpers of the port's Hopper kernels (bf16 wmma, fp32 softmax/LN).
//
// The first kernels take bf16 tensor-core products through nvcuda::wmma
// 16x16x16 fragments (mma.sync) with fp32 accumulation, operands read from
// shared memory or straight from global memory (L2-resident at the slice's
// sizes). The redesigned ones keep their products in registers by
// mma.sync (mma.cuh) or wgmma (wgmma.cuh) and stay resident in persistent
// blocks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace iuvl {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 to_bf(float x) { return __float2bfloat16(x); }
// Round an fp32 value to bf16 and back: a storage rounding point of the JAX math.
__device__ __forceinline__ float round_bf(float x) { return to_f(to_bf(x)); }

// tanh-approximated GELU (jax.nn.gelu(approximate=True)); the bf16 path's GELU.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy device -> shared memory (cp.async, bypassing L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The current device's SM count and shared memory (an SM's, and a block's
// opt-in limit), read once a device.
struct DeviceInfo {
  int sms, smem_per_sm, smem_per_block;
};
inline DeviceInfo device_info() {
  static DeviceInfo info[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo& d = info[dev & 63];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return d;
}

// Set the dynamic shared-memory limit and launch; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace iuvl
