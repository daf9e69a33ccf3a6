// Segmented scatter-add (B17):
//   out = zeros((n_out, W), f32); out[idx[r]] += contrib[r]   for each row r
// Replaces iuvl_tpu/ops/pallas/seg_scatter.py:segmented_scatter_add
// (_seg_kernel). JAX calls it nowhere; it was written for the deformable
// backward's d_value rows (688,128 rows of 256 into 131,072 rows at the
// batch-2 res3 level). Like JAX's function it takes rows of any width W >= 1
// in bf16, fp16 or fp32 and sums them in fp32.
//
// Bound on the card: bytes. Each contrib row is read once and each output
// row written once (fp32), with an fp32 add per element: at the d_value
// shape (bf16) 352 MB in and 134 MB out, ~0.15 ms at 3.35 TB/s.
//
// The TPU kernel sorted the rows by destination, packed them into chunks
// that each fall in one 512-row output window, and summed each chunk as a
// (block, chunk) one-hot matmul on the MXU into the VMEM-resident window,
// zeroing a window on its first chunk. A one-hot product is wasted work on
// the card; what carries over is the sort: the wrapper sorts the rows by
// destination (torch.argsort, stable, as JAX's own argsort runs outside
// its kernel) and hands the kernel idx and the sorted order; the kernel
// reads each row's destination through the order itself.
//
// The work is split by pieces of the sorted order, not by destination, so
// that no block sums a long segment alone (every row into one destination
// is 3000 rows on one SM otherwise). Pass 1: a block takes block_rows
// consecutive sorted rows (16 a lane group where that fits 1024 rows); its
// threads split as (lane group, 8-column group) over a slab of at most 2048
// columns (grid.y walks the slabs of a wider row), a lane group covering a
// row of the slab in pieces of 8 columns, each lane group summing its own
// rows in order in fp32 registers. A piece is read as 16-byte vectors where
// the row pitch keeps them aligned (W * sizeof(T) % 16 == 0), else element
// by element; the columns past W are masked. A destination's run of rows
// that lies inside one lane group's rows is written there; the partial sums
// of a run that crosses lane groups meet in shared memory and the lane
// group where the run starts adds them in order and writes the row; a run
// that crosses the block's end leaves its block's partial sum in a small
// scratch (two rows a block: the run the block starts with, the run it ends
// with), and pass 2 adds those in block order for the block where the run
// starts and writes the row. The destinations between two consecutive
// sorted rows (the key gaps) are written as zeros by the lane group of the
// later row; those before the first row and after the last by pass 2,
// across its grid. Every output row is written once, with no atomics and
// no zeroing pass, each sum in one fixed order: two launches give the same
// bits.
#include <cuda_fp16.h>

#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kSThreads = 256;
constexpr int kMaxRows = 1024;               // sorted rows a block at most
constexpr int kSlabCols = kSThreads * 8;     // columns a pass-1 block covers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Columns [col, col + n) of a row, n <= 8: as raw 16-byte vectors where
// kVec (the row pitch and col keep them aligned; n a multiple of a
// vector's elements), converted to fp32 where they are added; element by
// element otherwise, 0 past n.
template <typename T, bool kVec>
struct Piece {
  static constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte vector
  static constexpr int kVecs = 8 / kPer;
  uint4 raw[kVec ? kVecs : 1];
  float x[kVec ? 1 : 8];

  __device__ __forceinline__ void load(const T* row, int col, int n) {
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
        raw[v] = v * kPer < n ? *reinterpret_cast<const uint4*>(row + col + v * kPer)
                              : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = j < n ? to_f32(row[col + j]) : 0.f;
    }
  }
  __device__ __forceinline__ void add_to(float (&acc)[8]) const {
    if constexpr (kVec) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const T* e = reinterpret_cast<const T*>(&raw[v]);
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[v * kPer + j] += to_f32(e[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += x[j];
    }
  }
};

// An fp32 row's columns [col, col + n) from a[0 .. n): float4 stores where
// kVec4 (W % 4 == 0, so rows and col are 16-byte aligned).
template <bool kVec4>
__device__ __forceinline__ void store8(float* row, int col, int n, const float (&a)[8]) {
  float* dst = row + col;
  if (kVec4 && n == 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
  } else if (kVec4 && n == 4) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) dst[j] = a[j];
  }
}

// A run's partial sum of 8 columns in shared memory or the scratch (pitch a
// multiple of 8: always whole, aligned float4 pairs).
__device__ __forceinline__ void put8(float* dst, const float (&a)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

__device__ __forceinline__ void add8(float (&a)[8], const float* src) {
  const float4 x = reinterpret_cast<const float4*>(src)[0];
  const float4 y = reinterpret_cast<const float4*>(src)[1];
  a[0] += x.x, a[1] += x.y, a[2] += x.z, a[3] += x.w;
  a[4] += y.x, a[5] += y.y, a[6] += y.z, a[7] += y.w;
}

// scratch: part[block][2][pitch] fp32 (pitch: W rounded up to 8; 0: the
// partial of the run the block starts with, when it began before the block;
// 1: of the run it ends with, when that run began in the block and goes
// past it), then two ints a block: the destination of partial 1 (-1: none)
// and whether the block's first run also goes past the block.
template <typename T, bool kVec, bool kVec4>
__global__ void __launch_bounds__(kSThreads) seg_pass1_kernel(
    const T* __restrict__ contrib, const int* __restrict__ idx,
    const long long* __restrict__ order, float* __restrict__ out, float* __restrict__ part,
    int* __restrict__ flags, int rows, int n_out, int width, int block_rows) {
  __shared__ int skey[kMaxRows + 2];  // skey[1 + i]: the destination of sorted row b0 + i
  __shared__ int srow[kMaxRows];      // the contrib row of sorted row b0 + i
  __shared__ __align__(16) float first[kSThreads * 8], last[kSThreads * 8];
  __shared__ int s_own, s_thru;
  // This block's slab of columns [c0, c0 + sw): `groups` pieces of 8, a
  // lane group of `groups` threads a row; threads past lanes * groups idle.
  const int c0 = blockIdx.y * kSlabCols, sw = min(kSlabCols, width - c0);
  const int groups = (sw + 7) / 8, lanes = kSThreads / groups;
  const int chunk = (block_rows + lanes - 1) / lanes, pitch = groups * 8;
  const int pitch_all = (width + 7) / 8 * 8;  // the scratch's row pitch
  const int lane = threadIdx.x / groups, grp = threadIdx.x % groups;
  const int col = c0 + grp * 8, ncol = min(8, width - col);
  const int b0 = blockIdx.x * block_rows, nb = min(block_rows, rows - b0);
  // The block's rows, and the destinations of the rows just before and
  // after them (-1 and n_out past either end: no destination equals them).
  for (int i = threadIdx.x; i < nb; i += kSThreads) {
    const int r = static_cast<int>(order[b0 + i]);
    srow[i] = r;
    skey[1 + i] = idx[r];
  }
  if (threadIdx.x == 0) {
    skey[0] = b0 > 0 ? idx[order[b0 - 1]] : -1;
    skey[1 + nb] = b0 + nb < rows ? idx[order[b0 + nb]] : n_out;
    s_own = -1;
    s_thru = 0;
  }
  __syncthreads();
  const int* key = skey + 1;  // key[-1 .. nb]
  const int lcol = grp * 8;   // the piece's column in shared memory
  const int cs = lane * chunk, ce = min(cs + chunk, nb);
  const float zero8[8] = {};
  // Pass 1a: each lane group sums its rows [cs, ce) run by run.
  if (cs < ce) {
    float acc[8] = {};
    bool is_first = true;
    for (int i0 = cs; i0 < ce; i0 += 8) {
      Piece<T, kVec> x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < ce)
          x[u].load(contrib + static_cast<size_t>(srow[i0 + u]) * width, col, ncol);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u;
        if (i >= ce) break;
        const int kp = key[i - 1], kc = key[i];
        if (i > cs && kc != kp) {  // the run of kp ended at row i
          const bool before = is_first && key[cs - 1] == kp;
          if (!before) store8<kVec4>(out + static_cast<size_t>(kp) * width, col, ncol, acc);
          else put8(first + lane * pitch + lcol, acc);
          is_first = false;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = 0.f;
        }
        // Empty destinations between the previous row's and this one's.
        if (b0 + i > 0)
          for (int d = kp + 1; d < kc; ++d)
            store8<kVec4>(out + static_cast<size_t>(d) * width, col, ncol, zero8);
        x[u].add_to(acc);
      }
    }
    const int kl = key[ce - 1];
    const bool before = is_first && key[cs - 1] == kl, after = key[ce] == kl;
    if (!before && !after) store8<kVec4>(out + static_cast<size_t>(kl) * width, col, ncol, acc);
    else put8((is_first ? first : last) + lane * pitch + lcol, acc);
  }
  __syncthreads();
  // Pass 1b: runs that cross lane groups. Lane group m: its rows [m chunk,
  // ...); single: one run; before / after: its first / last run goes on
  // from the previous / into the next rows.
  const int used = (nb + chunk - 1) / chunk;
  auto end_of = [&](int m) { return min((m + 1) * chunk, nb); };
  auto single = [&](int m) { return key[m * chunk] == key[end_of(m) - 1]; };
  auto after = [&](int m) { return key[end_of(m)] == key[end_of(m) - 1]; };
  if (lane < used) {
    const bool before0 = key[cs - 1] == key[cs];
    // The run this lane group ends with, where it starts here and goes on.
    if (after(lane) && !(single(lane) && before0)) {
      float tot[8];
      const float* mine = (single(lane) ? first : last) + lane * pitch + lcol;
#pragma unroll
      for (int j = 0; j < 8; ++j) tot[j] = mine[j];
      int m = lane + 1;
      for (; m < used; ++m) {
        add8(tot, first + m * pitch + lcol);
        if (!(single(m) && after(m))) break;
      }
      const int kl = key[ce - 1];
      if (m < used) {
        store8<kVec4>(out + static_cast<size_t>(kl) * width, col, ncol, tot);
      } else {  // goes past the block: pass 2 finishes it
        put8(part + (static_cast<size_t>(blockIdx.x) * 2 + 1) * pitch_all + col, tot);
        if (grp == 0) s_own = kl;
      }
    }
    // The run the block starts with, where it began in an earlier block.
    if (lane == 0 && before0) {
      float tot[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) tot[j] = first[lcol + j];
      int m = 0;
      bool thru = false;
      while (single(m) && after(m)) {
        if (m + 1 == used) {
          thru = true;
          break;
        }
        ++m;
        add8(tot, first + m * pitch + lcol);
      }
      put8(part + static_cast<size_t>(blockIdx.x) * 2 * pitch_all + col, tot);
      if (grp == 0) s_thru = thru;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.y == 0) {  // the same in every slab
    flags[2 * blockIdx.x] = s_own;
    flags[2 * blockIdx.x + 1] = s_thru;
  }
}

// Pass 2: block b < blocks finishes the run its pass-1 block ended with
// (partial 1, then partial 0 of the blocks it runs through, in order); the
// whole grid writes zeros for the destinations before the first sorted row
// and after the last (every row when there are none).
template <bool kVec4>
__global__ void __launch_bounds__(kSThreads) seg_pass2_kernel(
    const int* __restrict__ idx, const long long* __restrict__ order, float* __restrict__ out,
    const float* __restrict__ part, const int* __restrict__ flags, int rows, int n_out,
    int width, int blocks) {
  const int b = blockIdx.x;
  const int pitch_all = (width + 7) / 8 * 8;
  if (b < blocks && flags[2 * b] >= 0) {
    const int dest = flags[2 * b];
    for (int c = threadIdx.x * 4; c < width; c += kSThreads * 4) {
      float4 t = *reinterpret_cast<const float4*>(part + (static_cast<size_t>(b) * 2 + 1) *
                                                  pitch_all + c);
      for (int m = b + 1; m < blocks; ++m) {
        const float4 x = *reinterpret_cast<const float4*>(part + static_cast<size_t>(m) * 2 *
                                                          pitch_all + c);
        t.x += x.x, t.y += x.y, t.z += x.z, t.w += x.w;
        if (!flags[2 * m + 1]) break;
      }
      float* o = out + static_cast<size_t>(dest) * width + c;
      if (kVec4) {
        *reinterpret_cast<float4*>(o) = t;
      } else {
        const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < width) o[j] = v[j];
      }
    }
  }
  const int lead = rows > 0 ? idx[order[0]] : n_out;
  const int tail0 = rows > 0 ? idx[order[rows - 1]] + 1 : n_out;
  // The zeros in pieces of 4 floats (whole float4 where kVec4, else single).
  constexpr int kPiece = kVec4 ? 4 : 1;
  const size_t per_row = width / kPiece, n_lead = static_cast<size_t>(lead) * per_row;
  const size_t total = n_lead + static_cast<size_t>(n_out - tail0) * per_row;
  for (size_t i = static_cast<size_t>(b) * kSThreads + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * kSThreads) {
    const size_t at = i < n_lead ? i : i - n_lead + static_cast<size_t>(tail0) * per_row;
    if (kVec4) reinterpret_cast<float4*>(out)[at] = make_float4(0.f, 0.f, 0.f, 0.f);
    else out[at] = 0.f;
  }
}

template <typename T>
int seg_scatter(const void* contrib, const int* idx, const long long* order, float* out,
                float* part, int* flags, int rows, int n_out, int width, int block_rows,
                int blocks, cudaStream_t s) {
  const bool vec = width * sizeof(T) % 16 == 0, vec4 = width % 4 == 0;
  const dim3 grid(blocks, (width + kSlabCols - 1) / kSlabCols);
  const auto* c = static_cast<const T*>(contrib);
  if (blocks > 0) {
    if (vec)  // W * sizeof(T) % 16 == 0 implies W % 4 == 0
      seg_pass1_kernel<T, true, true><<<grid, kSThreads, 0, s>>>(
          c, idx, order, out, part, flags, rows, n_out, width, block_rows);
    else if (vec4)
      seg_pass1_kernel<T, false, true><<<grid, kSThreads, 0, s>>>(
          c, idx, order, out, part, flags, rows, n_out, width, block_rows);
    else
      seg_pass1_kernel<T, false, false><<<grid, kSThreads, 0, s>>>(
          c, idx, order, out, part, flags, rows, n_out, width, block_rows);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  const int grid2 = blocks > 64 ? blocks : 64;  // the zeros' rows spread over at least 64
  if (vec4)
    seg_pass2_kernel<true><<<grid2, kSThreads, 0, s>>>(idx, order, out, part, flags, rows,
                                                       n_out, width, blocks);
  else
    seg_pass2_kernel<false><<<grid2, kSThreads, 0, s>>>(idx, order, out, part, flags, rows,
                                                        n_out, width, blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// contrib (R, W) of dtype 0: bf16, 1: fp16, 2: fp32; idx (R,) int32 in
// [0, n_out); order (R,) int64, the rows sorted by destination (stable);
// out (n_out, W) fp32, every row written; scratch fp32, 2 P + 2 values for
// each block of block_rows sorted rows (ceil(R / block_rows) blocks; P: W
// rounded up to a multiple of 8). Any W >= 1; block_rows at most 1024.
extern "C" int iuvl_seg_scatter(const void* contrib, const void* idx, const void* order,
                                void* out, void* scratch, int rows, int n_out, int width,
                                int block_rows, int dtype, void* stream) {
  if (width < 1 || n_out < 1 || rows < 0 || block_rows < 1 || block_rows > kMaxRows ||
      dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + block_rows - 1) / block_rows;
  float* part = static_cast<float*>(scratch);
  int* flags = reinterpret_cast<int*>(part + static_cast<size_t>(blocks) * 2 *
                                                 ((width + 7) / 8 * 8));
  const auto* ix = static_cast<const int*>(idx);
  const auto* ord = static_cast<const long long*>(order);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return seg_scatter<bf16>(contrib, ix, ord, o, part, flags, rows, n_out, width, block_rows,
                             blocks, s);
  if (dtype == 1)
    return seg_scatter<__half>(contrib, ix, ord, o, part, flags, rows, n_out, width,
                               block_rows, blocks, s);
  return seg_scatter<float>(contrib, ix, ord, o, part, flags, rows, n_out, width, block_rows,
                            blocks, s);
}
