// Cotangent glue of the deformable backward (B8): for tap rows g4 (R, 4d),
// the output cotangent gout (Q, d) fp32 (R = Q * p: p sampling points a
// query) and the folded slot weights wa (R, 4) fp32,
//   contrib[r, d s + c] = wa[r, s] * gout[r / p, c]     (in g4's type)
//   dots[r, s] = sum_c g4[r, d s + c] * gout[r / p, c]  (fp32)
// d, the head width, a multiple of 16 from 16 to 128.
// Replaces iuvl_tpu/ops/pallas/deform_bwd_glue.py: deform_bwd_glue_q (the
// query-row layout, JAX's default) and deform_bwd_glue (the row layout), one
// entry point each with JAX's contract.
//
// Bound on the card: bytes. Per image and level at res3 (R = 688128, d 64):
// g4 and contrib 352 MB each in bf16, gout 44 MB, wa and dots 11 MB each;
// two multiply-adds per element of g4. The TPU kernel built the tiled
// cotangent in VMEM to keep it out of HBM; here it lives in registers and is
// never written: lane l of a warp owns slot l / 8 and channels 8 (l % 8) .. + 7
// of each 64-channel pass of a row (lanes past d idle), holds those
// cotangent values (8 a pass, two passes at most), reads its 16 bytes of g4
// a pass (32 in fp32), adds its products over the passes in order, and the
// 8 lanes of a slot sum their partial dot with shuffles.
// contrib is rounded to g4's type as the Pallas kernel rounds it.
// - glue_q: a warp per query: the cotangent is read once and serves the
//   query's p rows.
// - glue (row layout): a warp per row: each row reads its query's cotangent.
// Both run the same arithmetic on each row, so their results are identical.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kPass = 64;     // channels of a slot a pass, 8 a lane
constexpr int kMaxPasses = 2;  // d <= 128; the kernels take the pass count as a template argument
constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float f[8]) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float f[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// This lane's channels of pass i: 8 (lane % 8) + 64 i .. + 7, live below d.
__device__ __forceinline__ int pass_col(int i, int lane) { return kPass * i + 8 * (lane & 7); }

// The lane's cotangent values of a query, 8 a live pass (zeros past d).
template <int kPasses>
__device__ __forceinline__ void load_gout(const float* __restrict__ gout, size_t query, int lane,
                                          int d, float (&g)[kPasses][8]) {
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    if (pass_col(i, lane) < d) {
      load8(gout + query * d + pass_col(i, lane), g[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
    }
  }
}

// One row r, as lane `lane` of its warp sees it; g holds this lane's
// cotangent values.
template <typename T, int kPasses>
__device__ __forceinline__ void glue_row(const T* __restrict__ g4, const float* __restrict__ wa,
                                         T* __restrict__ contrib, float* __restrict__ dots,
                                         size_t r, int lane, int d, const float (&g)[kPasses][8]) {
  const int slot = lane >> 3;
  const size_t row = r * 4 * d + slot * d;
  const float a = wa[r * 4 + slot];
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int c0 = pass_col(i, lane);
    if (c0 < d) {
      float v[8];
      load8(g4 + row + c0, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dot += v[j] * g[i][j];
      float c[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = a * g[i][j];
      store8(contrib + row + c0, c);
    }
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  dot += __shfl_xor_sync(0xffffffffu, dot, 4);
  if ((lane & 7) == 0) dots[r * 4 + slot] = dot;
}

template <typename T, int kPasses>
__global__ void glue_q_kernel(const T* __restrict__ g4, const float* __restrict__ gout,
                              const float* __restrict__ wa, T* __restrict__ contrib,
                              float* __restrict__ dots, int q, int p, int d) {
  const int warp = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                     threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= q) return;
  float g[kPasses][8];
  load_gout<kPasses>(gout, warp, lane, d, g);
  for (int k = 0; k < p; ++k)
    glue_row<T, kPasses>(g4, wa, contrib, dots, static_cast<size_t>(warp) * p + k, lane, d, g);
}

template <typename T, int kPasses>
__global__ void glue_rows_kernel(const T* __restrict__ g4, const float* __restrict__ gout,
                                 const float* __restrict__ wa, T* __restrict__ contrib,
                                 float* __restrict__ dots, int rows, int p, int d) {
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float g[kPasses][8];
  load_gout<kPasses>(gout, r / p, lane, d, g);
  glue_row<T, kPasses>(g4, wa, contrib, dots, static_cast<size_t>(r), lane, d, g);
}

unsigned blocks_for(size_t warps) {
  return static_cast<unsigned>((warps * 32 + kThreadsPerBlock - 1) / kThreadsPerBlock);
}

template <typename T, int kPasses>
int launch_glue(bool query_rows, const void* g4, const void* gout, const void* wa, void* contrib,
                void* dots, int q, int p, int d, cudaStream_t s) {
  const auto* g = static_cast<const T*>(g4);
  const auto* go = static_cast<const float*>(gout);
  const auto* a = static_cast<const float*>(wa);
  auto* c = static_cast<T*>(contrib);
  auto* dt = static_cast<float*>(dots);
  if (query_rows)
    glue_q_kernel<T, kPasses><<<blocks_for(q), kThreadsPerBlock, 0, s>>>(g, go, a, c, dt, q, p,
                                                                          d);
  else
    glue_rows_kernel<T, kPasses><<<blocks_for(static_cast<size_t>(q) * p), kThreadsPerBlock, 0,
                                   s>>>(g, go, a, c, dt, q * p, p, d);
  return static_cast<int>(cudaGetLastError());
}

int glue(bool query_rows, const void* g4, const void* gout, const void* wa, void* contrib,
         void* dots, int q, int p, int d, int bf16_values, void* stream) {
  if (d < 16 || d > kPass * kMaxPasses || d % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(q) * p == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= kPass)
    return bf16_values ? launch_glue<bf16, 1>(query_rows, g4, gout, wa, contrib, dots, q, p, d, s)
                       : launch_glue<float, 1>(query_rows, g4, gout, wa, contrib, dots, q, p, d, s);
  return bf16_values ? launch_glue<bf16, 2>(query_rows, g4, gout, wa, contrib, dots, q, p, d, s)
                     : launch_glue<float, 2>(query_rows, g4, gout, wa, contrib, dots, q, p, d, s);
}

}  // namespace
}  // namespace iuvl

// g4 (q * p, 4d) bf16 (bf16 != 0) or fp32; gout (q, d) fp32; wa (q * p, 4)
// fp32; contrib like g4; dots (q * p, 4) fp32.
extern "C" int iuvl_deform_bwd_glue_q(const void* g4, const void* gout, const void* wa,
                                      void* contrib, void* dots, int q, int p, int d,
                                      int bf16_values, void* stream) {
  return iuvl::glue(true, g4, gout, wa, contrib, dots, q, p, d, bf16_values, stream);
}

extern "C" int iuvl_deform_bwd_glue(const void* g4, const void* gout, const void* wa,
                                    void* contrib, void* dots, int q, int p, int d,
                                    int bf16_values, void* stream) {
  return iuvl::glue(false, g4, gout, wa, contrib, dots, q, p, d, bf16_values, stream);
}
