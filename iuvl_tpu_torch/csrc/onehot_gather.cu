// One-hot deformable level forward (B15). Replaces the Pallas kernel
// onehot_deform_level_forward (iuvl_tpu/ops/pallas/onehot_gather.py:57,
// pallas_call at :70), which iuvl_tpu/ops/msdeform.py's 'hybrid' core runs
// on every level of at most 1536 cells (res5 at 1024^2):
//
//   out[r, c] = sum_s sum_cell rnd(sum_{p: idx[r,p] = cell} ws[r, s, p]) * v4[b(r), cell, s*d + c]
//
// v4 (BH, cells, 4d) bf16 or fp32 (the wide map [v, roll -1, roll -w,
// roll -(w+1)]), idx (BH, Lq, P) int32 clipped top-left cells, wslot
// (BH, Lq, 4, P) fp32 slot weights with the attention weight folded in;
// out (BH, Lq, d) in v4's dtype, d = 64. rnd is the rounding to v4's dtype.
//
// The TPU kernel built, per query block and slot, a dense one-hot weight
// matrix (block, cells) with VPU compares and multiplied it with the table
// on the MXU: the TPU issues gathers slowly. Here a gather is cheap and
// the dense form would be ~90 GFLOP a call for ~0.35 GFLOP of work, so the
// kernel gathers. What it keeps of the TPU arithmetic: the weights of the
// points of a row that hit the same cell add in fp32, in point order from
// 0, and are rounded to v4's dtype once, before the product; products of
// all slots and points add in fp32; the output is rounded once.
//
// Design: a warp per (bh, query) row, two channels a lane, P (1-8) a
// template parameter; the row's indices and merged weights in registers;
// per slot and point one 128-byte row piece (bf16) from the table, which
// at res5 is 4 MB for 8 heads and stays in L2, all 4P loads issued before
// the first product. An index outside [0, cells) hits no cell, as in the
// one-hot compare.
//
// Bound on the card at the hybrid eval's res5 shape (BH 8, cells 1024,
// Lq 21504, P 4; chip_smoke.py `work`): bytes, ~40 MB (wslot 11 MB, idx
// 2.8 MB, v4 4.2 MB in, out 22 MB), ~12 us at 3.35 TB/s; <= 0.35 GFLOP
// of fp32 multiply-adds (0.30 on chip_smoke.py's inputs), ~5 us at 67 TFLOP/s.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kD = 64;
constexpr int kRowThreads = 256;  // 8 warps a block, a warp per row

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float round_to(bf16*, float x) { return round_bf(x); }
__device__ __forceinline__ float round_to(float*, float x) { return x; }

// A row's P points and 4 slots: first the merged, rounded weight of each
// (slot, distinct cell) and the cell to read (a point merged into an
// earlier one, or outside the table, gets weight 0 and reads cell 0), then
// all 4P row pieces are loaded at once, then the products are summed in
// slot-then-point order. Loads that do not wait on each other keep 4P L2
// reads of a warp in flight.
template <typename T, int P>
__global__ void onehot_level_kernel(const T* __restrict__ v4, const int* __restrict__ idx,
                                    const float* __restrict__ wslot, T* __restrict__ out,
                                    int rows, int lq, int cells) {
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* table = v4 + static_cast<size_t>(r / lq) * cells * 4 * kD + 2 * lane;
  const float* ws = wslot + static_cast<size_t>(r) * 4 * P;
  int id[P];
#pragma unroll
  for (int k = 0; k < P; ++k) id[k] = idx[static_cast<size_t>(r) * P + k];
  float w[4][P];
  int cell[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    bool first = id[k] >= 0 && id[k] < cells;
#pragma unroll
    for (int j = 0; j < k; ++j) first = first && id[j] != id[k];
    cell[k] = first ? id[k] : 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float sum = 0.f;
#pragma unroll
      for (int j = k; j < P; ++j)
        if (id[j] == id[k]) sum += ws[s * P + j];
      w[s][k] = first ? round_to(static_cast<T*>(nullptr), sum) : 0.f;
    }
  }
  float2 val[4][P];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < P; ++k)
      val[s][k] = load2(table + static_cast<size_t>(cell[k]) * 4 * kD + s * kD);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < P; ++k) {
      acc0 = fmaf(w[s][k], val[s][k].x, acc0);
      acc1 = fmaf(w[s][k], val[s][k].y, acc1);
    }
  store2(out + static_cast<size_t>(r) * kD + 2 * lane, acc0, acc1);
}

unsigned row_blocks(size_t warps) {
  return static_cast<unsigned>((warps * 32 + kRowThreads - 1) / kRowThreads);
}

template <typename T, int P>
int launch_rows(const T* v4, const int* idx, const float* ws, T* out, size_t rows, int lq,
                int cells, cudaStream_t s) {
  onehot_level_kernel<T, P><<<row_blocks(rows), kRowThreads, 0, s>>>(
      v4, idx, ws, out, static_cast<int>(rows), lq, cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(const T* v4, const int* idx, const float* ws, T* out, size_t rows, int lq,
             int cells, int p, cudaStream_t s) {
  switch (p) {
    case 1: return launch_rows<T, 1>(v4, idx, ws, out, rows, lq, cells, s);
    case 2: return launch_rows<T, 2>(v4, idx, ws, out, rows, lq, cells, s);
    case 3: return launch_rows<T, 3>(v4, idx, ws, out, rows, lq, cells, s);
    case 4: return launch_rows<T, 4>(v4, idx, ws, out, rows, lq, cells, s);
    case 5: return launch_rows<T, 5>(v4, idx, ws, out, rows, lq, cells, s);
    case 6: return launch_rows<T, 6>(v4, idx, ws, out, rows, lq, cells, s);
    case 7: return launch_rows<T, 7>(v4, idx, ws, out, rows, lq, cells, s);
    case 8: return launch_rows<T, 8>(v4, idx, ws, out, rows, lq, cells, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// v4: (bh, cells, 256) bf16 (bf16 != 0) or fp32; idx: (bh, lq, p) int32;
// wslot: (bh, lq, 4, p) fp32; out: (bh, lq, 64) in v4's dtype; 1 <= p <= 8.
extern "C" int iuvl_onehot_level_fwd(const void* v4, const void* idx, const void* wslot,
                                     void* out, int bh, int cells, int lq, int p,
                                     int bf16_values, void* stream) {
  const size_t rows = static_cast<size_t>(bh) * lq;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  const auto* ws = static_cast<const float*>(wslot);
  if (bf16_values)
    return launch_p(static_cast<const bf16*>(v4), ix, ws, static_cast<bf16*>(out), rows, lq,
                    cells, p, s);
  return launch_p(static_cast<const float*>(v4), ix, ws, static_cast<float*>(out), rows, lq,
                  cells, p, s);
}
