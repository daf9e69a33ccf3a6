// Multi-scale deformable attention, one level (B7): the forward, the tap-row
// gather and the d_value scatter of the backward. Replaces the flat core of
// iuvl_tpu/ops/msdeform.py: _flat_level_fwd_impl (the forward), and in
// _flat_level_bwd the gather _flat_gather_rows(_wide_map(v)) and the dv4
// scatter-add followed by the inverse-roll fold into d_value. (The JAX core
// is XLA, not Pallas; the system it ports ran it as a CUDA kernel.)
//
// The four bilinear taps of a sampling point are the flat rows
// (idx + off) mod hw of its head's (hw, d) map, off in {0, 1, w, w + 1}, with
// idx the clipped top-left pixel: the rows _wide_map's rolls put side by side
// (the mod is their wrap). A slot that leaves the map, or wraps, carries weight
// 0 (the clip and validity of _wide_idx_wslot), so the wide map is never built.
// d (the head width) is 64: lanes own fixed channels of a row.
//
// Bounds on the card at the res3 level of a batch-2 train step (8 heads,
// hw 128^2, 21504 queries x 4 points; chip_smoke.py `work` computes them):
// all three move bytes and do few operations.
// - forward: v (bf16, 34 MB for two images), x, y, aw (fp32, 17 MB) in,
//   the fp32 (B, nh, Lq, 64) level output (88 MB) out. A warp per (image,
//   head, query), two channels a lane, 16 tap rows of 128 bytes; fp32 sums.
// - gather: the rows g4 (R, 4d) = 352 MB bf16 per image out, from a 17 MB
//   map that stays in L2. A warp a row, 16 bytes a lane.
// - scatter: contrib (R, 4d) 352 MB in, d_value (nh, hw, 64) fp32 out. A
//   warp a row, 8 channels a lane, added with vector fp32 atomics
//   (atomicAdd on float4, sm_90): rows of nearby queries hit the same
//   cells, so the order of their sums is not fixed and results differ
//   between runs by fp32 rounding (chip_smoke.py's bound allows for it).
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kD = 64;

// _wide_idx_wslot: the clipped top-left flat index and the four slot weights
// with zero-padding validity, in fp32, in JAX's order of operations.
struct WideTaps {
  int idx;
  float w[4];
};

__device__ __forceinline__ float in_range(float t, float hi) {
  return (t >= 0.f && t <= hi) ? 1.f : 0.f;
}

__device__ __forceinline__ WideTaps wide_taps(float x, float y, int h, int w) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const float x0c = fminf(fmaxf(x0, 0.f), static_cast<float>(w - 1));
  const float y0c = fminf(fmaxf(y0, 0.f), static_cast<float>(h - 1));
  const float px = x0c - x0, py = y0c - y0;
  const float wx0 = (1.f - fx) * in_range(x0, static_cast<float>(w - 1));
  const float wx1 = fx * in_range(x0 + 1.f, static_cast<float>(w - 1));
  const float wy0 = (1.f - fy) * in_range(y0, static_cast<float>(h - 1));
  const float wy1 = fy * in_range(y0 + 1.f, static_cast<float>(h - 1));
  const float sx0 = px > 0.f ? wx1 : wx0;
  const float sx1 = px > 0.f ? 0.f : wx1;
  const float sy0 = py > 0.f ? wy1 : wy0;
  const float sy1 = py > 0.f ? 0.f : wy1;
  WideTaps t;
  t.idx = static_cast<int>(y0c * static_cast<float>(w) + x0c);
  t.w[0] = sy0 * sx0;
  t.w[1] = sy0 * sx1;
  t.w[2] = sy1 * sx0;
  t.w[3] = sy1 * sx1;
  return t;
}

__device__ __forceinline__ int tap_row(int idx, int slot, int w, int hw) {
  const int off = (slot & 1) + (slot >> 1) * w;  // 0, 1, w, w + 1
  return (idx + off) % hw;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// out[b, h, q, :] = sum over points k and slots s of wa[k, s] * v[b, h, row(k, s), :]
template <typename T>
__global__ void level_fwd_kernel(const T* __restrict__ v, const float* __restrict__ x,
                                 const float* __restrict__ y, const float* __restrict__ aw,
                                 float* __restrict__ out, int total, int lq, int p, int h,
                                 int w) {
  const int warp = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                     threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= total) return;
  const int hw = h * w;
  const T* map = v + static_cast<size_t>(warp / lq) * hw * kD + 2 * lane;
  const size_t q = static_cast<size_t>(warp) * p;
  float acc0 = 0.f, acc1 = 0.f;
  for (int k = 0; k < p; ++k) {
    const WideTaps t = wide_taps(x[q + k], y[q + k], h, w);
    const float a = aw[q + k];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float wa = t.w[s] * a;
      const float2 val = load2(map + static_cast<size_t>(tap_row(t.idx, s, w, hw)) * kD);
      acc0 += wa * val.x;
      acc1 += wa * val.y;
    }
  }
  *reinterpret_cast<float2*>(out + static_cast<size_t>(warp) * kD + 2 * lane) =
      make_float2(acc0, acc1);
}

// Lane l of a row's warp owns slot l / 8, channels 8 (l % 8) .. + 7: 8
// elements, one 16-byte piece in bf16, two in fp32.
template <typename T>
struct Piece {
  static constexpr int kVecs = sizeof(T) * 8 / 16;
  uint4 u[kVecs];
};

template <typename T>
__device__ __forceinline__ Piece<T> load_piece(const T* p) {
  Piece<T> r;
#pragma unroll
  for (int i = 0; i < Piece<T>::kVecs; ++i) r.u[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

__device__ __forceinline__ void piece_floats(const Piece<bf16>& pc, float f[8]) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(pc.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(b[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void piece_floats(const Piece<float>& pc, float f[8]) {
  const float* s = reinterpret_cast<const float*>(pc.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = s[i];
}

// g4[r, 64 s + c] = v[head(r), row(idx[r], s), c]
template <typename T>
__global__ void gather_kernel(const T* __restrict__ v, const int* __restrict__ idx,
                              T* __restrict__ g4, int rows, int per_head, int hw, int w) {
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int slot = lane >> 3, c = 8 * (lane & 7);
  const size_t src = (static_cast<size_t>(r / per_head) * hw + tap_row(idx[r], slot, w, hw)) * kD;
  const Piece<T> pc = load_piece(v + src + c);
  uint4* dst = reinterpret_cast<uint4*>(g4 + static_cast<size_t>(r) * 4 * kD + 8 * lane);
#pragma unroll
  for (int i = 0; i < Piece<T>::kVecs; ++i) dst[i] = pc.u[i];
}

// dv[head(r), row(idx[r], s), c] += contrib[r, 64 s + c], in fp32
template <typename T>
__global__ void scatter_kernel(const T* __restrict__ contrib, const int* __restrict__ idx,
                               float* __restrict__ dv, int rows, int per_head, int hw, int w) {
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int slot = lane >> 3, c = 8 * (lane & 7);
  float f[8];
  piece_floats(load_piece(contrib + static_cast<size_t>(r) * 4 * kD + 8 * lane), f);
  float4* dst = reinterpret_cast<float4*>(
      dv + (static_cast<size_t>(r / per_head) * hw + tap_row(idx[r], slot, w, hw)) * kD + c);
  atomicAdd(dst, make_float4(f[0], f[1], f[2], f[3]));
  atomicAdd(dst + 1, make_float4(f[4], f[5], f[6], f[7]));
}

constexpr int kRowThreads = 256;  // 8 warps a block, a warp per row

unsigned row_blocks(size_t warps) {
  return static_cast<unsigned>((warps * 32 + kRowThreads - 1) / kRowThreads);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// v: (B, nh, h*w, 64) bf16 (bf16 != 0) or fp32; x, y, aw: (B, nh, lq, p) fp32
// pixel coordinates and attention weights; out: (B, nh, lq, 64) fp32.
extern "C" int iuvl_msdeform_fwd(const void* v, const void* x, const void* y, const void* aw,
                                 void* out, int b, int nh, int lq, int p, int h, int w,
                                 int bf16_values, void* stream) {
  const size_t total = static_cast<size_t>(b) * nh * lq;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* af = static_cast<const float*>(aw);
  auto* o = static_cast<float*>(out);
  if (bf16_values)
    level_fwd_kernel<<<row_blocks(total), kRowThreads, 0, s>>>(
        static_cast<const bf16*>(v), xf, yf, af, o, static_cast<int>(total), lq, p, h, w);
  else
    level_fwd_kernel<<<row_blocks(total), kRowThreads, 0, s>>>(
        static_cast<const float*>(v), xf, yf, af, o, static_cast<int>(total), lq, p, h, w);
  return static_cast<int>(cudaGetLastError());
}

// One image: v (nh, hw, 64); idx (nh, per_head) int32 top-left rows in
// [0, hw); g4 (nh * per_head, 256) in v's type.
extern "C" int iuvl_deform_gather(const void* v, const void* idx, void* g4, int nh, int per_head,
                                  int hw, int w, int bf16_values, void* stream) {
  const size_t rows = static_cast<size_t>(nh) * per_head;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  if (bf16_values)
    gather_kernel<<<row_blocks(rows), kRowThreads, 0, s>>>(
        static_cast<const bf16*>(v), ix, static_cast<bf16*>(g4), static_cast<int>(rows),
        per_head, hw, w);
  else
    gather_kernel<<<row_blocks(rows), kRowThreads, 0, s>>>(
        static_cast<const float*>(v), ix, static_cast<float*>(g4), static_cast<int>(rows),
        per_head, hw, w);
  return static_cast<int>(cudaGetLastError());
}

// One image: contrib (nh * per_head, 256) bf16 or fp32; idx as for the
// gather; dv (nh, hw, 64) fp32, zeroed by the caller.
extern "C" int iuvl_deform_scatter(const void* contrib, const void* idx, void* dv, int nh,
                                   int per_head, int hw, int w, int bf16_values, void* stream) {
  const size_t rows = static_cast<size_t>(nh) * per_head;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  auto* d = static_cast<float*>(dv);
  if (bf16_values)
    scatter_kernel<<<row_blocks(rows), kRowThreads, 0, s>>>(
        static_cast<const bf16*>(contrib), ix, d, static_cast<int>(rows), per_head, hw, w);
  else
    scatter_kernel<<<row_blocks(rows), kRowThreads, 0, s>>>(
        static_cast<const float*>(contrib), ix, d, static_cast<int>(rows), per_head, hw, w);
  return static_cast<int>(cudaGetLastError());
}
