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
// out (BH, Lq, d) in v4's dtype, d a multiple of 16 from 16 to 128. rnd is
// the rounding to v4's dtype.
//
// The TPU kernel built, per query block and slot, a dense one-hot weight
// matrix (block, cells) with VPU compares and multiplied it with the table
// on the MXU: the TPU issues gathers slowly. Here a gather is cheap and
// the dense form would be ~90 GFLOP a call for ~0.35 GFLOP of work, so the
// kernel gathers. What it keeps of the TPU arithmetic: the weights of the
// points of a row that hit the same cell add in fp32, in point order from
// 0, and are rounded to v4's dtype once, before the product; products of
// all slots and points add in fp32, slot by slot, each slot's points in
// order (one fmaf chain a channel); the output is rounded once. An index
// outside [0, cells) hits no cell, as in the one-hot compare.
//
// Bound on the card at the hybrid eval's res5 shape (BH 8, cells 1024,
// Lq 21504, P 4; chip_smoke.py `work`): bytes, ~40 MB (wslot 11 MB, idx
// 2.8 MB, v4 4.2 MB in, out 22 MB), ~12 us at 3.35 TB/s; <= 0.35 GFLOP
// of fp32 multiply-adds, ~5 us at 67 TFLOP/s. A row reads 4P pieces of the
// table, 352 MB a call at res5: from L2 that alone took the first design
// (a warp a row) 0.071 ms.
//
// Design (the shared-memory instance, P 4): a block a (head, channel
// group, query range), the ranges chosen so that the blocks fill the SMs
// once. A channel group is 32 bytes of each slot's channels (16 bf16 or 8
// fp32 channels, 8 four-byte units); the block holds its group of every
// cell in shared memory, as [cell][unit][slot] words, 128 bytes a cell:
// 128 KB at 1024 cells, loaded once from L2 in 16-byte pieces, four word
// stores a piece in an order rotated by the cell so that a warp's stores
// hit 32 banks. 16 warps then walk their own 8-row pieces of the range,
// their idx and wslot streamed into a 3-stage cp.async ring a warp (no
// block-wide barrier after the table: the warps drift apart, and one
// warp's table reads overlap another's arithmetic). Four lanes serve a
// row, two units a lane: lane q merges the weights of slot q (the merge is
// the same for every channel; in bf16 the rounded weights travel two a
// shuffle), the row's four lanes swap them by shuffles, then each lane
// reads, per point, one 16-byte word quad (a unit's four slots) for each
// of its units and runs the four channels' fmaf chains side by side. The
// two rows of a quarter-warp read units {0,2,4,6} and {1,3,5,7} of their
// cells first and the others second, so a quarter-warp's eight 16-byte
// reads fall on eight bank groups whatever the cells. Other P, and tables
// past the shared memory (more than ~1570 cells), take the L2 instance: a
// warp a row, two channels a lane, 64 channels a pass, all 4P loads of a
// pass issued before the first product (P a template argument, as in the
// first design). Both sum each channel in the same order.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kMaxP = 8;
constexpr int kUnits = 8;                    // 4-byte units of a channel group
constexpr int kCellBytes = kUnits * 16;      // a cell's group in shared memory: 4 slots a unit
constexpr int kWarps = 16;                   // the shared-memory instance: its warps,
constexpr int kWarpRows = 8;                 // a warp's rows a step, 4 lanes a row
constexpr int kStageBytes = kWarpRows * 80;  // a step's rows: 16 slot weights, 4 indices a row
constexpr int kStages = 3;                   // a warp's ring of its rows
constexpr int kRowThreads = 256;             // the L2 instance: 8 warps, a warp a row

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

// A 4-byte unit's channels as floats: a bf16 pair (the low half first; a
// bf16 widens to fp32 exactly, as its bits in the high half), or one fp32.
__device__ __forceinline__ void unit_floats(bf16*, uint32_t u, float (&f)[2]) {
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void unit_floats(float*, uint32_t u, float (&f)[1]) {
  f[0] = __uint_as_float(u);
}
// Two units' sums (lo, hi), rounded once, as 8 bytes of the output row.
__device__ __forceinline__ void store_units(bf16* p, const float (&lo)[2], const float (&hi)[2]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(lo[0], lo[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(hi[0], hi[1]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void store_units(float* p, const float (&lo)[1], const float (&hi)[1]) {
  *reinterpret_cast<float2*>(p) = make_float2(lo[0], hi[0]);
}

__device__ __forceinline__ void cp_async16_to(unsigned dst, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ uint32_t quad_word(const uint4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// The merge of a row's P points: the cell each point reads (a point merged
// into an earlier one, or outside the table, reads cell 0 with weight 0)
// and, for each of kS slots, its weight: the fp32 sum in point order of the
// slot weights of the points that hit its cell, rounded once. (The sum
// starts at the point's own weight, not at 0 + it: the two differ only in
// the sign of a zero, which no product and no sum of the output sees.)
template <typename T, int kP, int kS>
__device__ __forceinline__ void merge(const int (&id)[kP], const float (&ws)[kS][kP], int cells,
                                      int (&cell)[kP], float (&w)[kS][kP]) {
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    bool first = static_cast<unsigned>(id[k]) < static_cast<unsigned>(cells);
#pragma unroll
    for (int j = 0; j < k; ++j) first = first && id[j] != id[k];
    cell[k] = first ? id[k] : 0;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      float sum = ws[s][k];
#pragma unroll
      for (int j = k + 1; j < kP; ++j)
        if (id[j] == id[k]) sum += ws[s][j];
      w[s][k] = first ? round_to(static_cast<T*>(nullptr), sum) : 0.f;
    }
  }
}

// ------------------------------------------------- shared-memory instance --
// The block's table: 16-byte chunk i = (cell, slot, half) of the group
// holds the words (cell, 4 half + t, slot), t = 0..3, stored in the order
// t = (r + cell) % 4 (a warp's stores on 32 banks); kBatch chunks a thread
// in flight. Ends with the barrier that makes the table whole.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_table(uint32_t* table, const T* v4, int cells, int d) {
  constexpr int kBatch = 8;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(v4);
  const size_t slot_bytes = static_cast<size_t>(d) * sizeof(T);
  const int end = cells * 8;
  for (int i0 = threadIdx.x; i0 < end; i0 += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = min(i0 + b * kThreads, end - 1);
      v[b] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(i >> 1) * slot_bytes +
                                                  (i & 1) * 16));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = i0 + b * kThreads;
      if (i < end) {
        const int cell = i >> 3;
        uint32_t* dst = table + cell * 32 + (i & 1) * 16 + ((i >> 1) & 3);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = (r + cell) & 3;
          dst[4 * t] = quad_word(v[b], t);
        }
      }
    }
  }
  __syncthreads();
}

// P 4. Grid (ranges, groups, BH); a block `range_rows` rows, warp w its
// pieces w, w + kWarps, ... of 8 rows.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 1) onehot_smem_kernel(
    const T* __restrict__ v4, const int* __restrict__ idx, const float* __restrict__ wslot,
    T* __restrict__ out, int lq, int cells, int d, int range_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // channels a unit
  const int g = blockIdx.y, bh = blockIdx.z;
  const int r_begin = blockIdx.x * range_rows, r_end = min(lq, r_begin + range_rows);
  if (r_begin >= r_end) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned char* ring = smem + static_cast<size_t>(cells) * kCellBytes +
                              warp * kStages * kStageBytes;
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const size_t head_row = static_cast<size_t>(bh) * lq;

  constexpr int kStep = kWarps * kWarpRows;  // rows from one of a warp's steps to the next
  // The warp's next step of rows into its next ring slot: lane l the l-th
  // 16-byte piece of their slot weights, lanes 0-7 a row's indices.
  int next_r0 = r_begin + warp * kWarpRows, next_slot = 0;
  const float* next_ws = wslot + (head_row + next_r0) * 16 + 4 * lane;
  const int* next_id = idx + (head_row + next_r0 + lane) * 4;
  auto stage = [&]() {
    const int n = min(kWarpRows, r_end - next_r0);
    const unsigned dst = ring_s + next_slot * kStageBytes + 16 * lane;
    if (lane < 4 * n) cp_async16_to(dst, next_ws);
    if (lane < n) cp_async16_to(dst + kWarpRows * 64, next_id);
    cp_async_commit();
    next_r0 += kStep;
    next_slot = next_slot + 1 == kStages ? 0 : next_slot + 1;
    next_ws += kStep * 16;
    next_id += kStep * 4;
  };
  for (int it = 0; it < kStages - 1; ++it) stage();
  stage_table<T, kWarps * 32>(reinterpret_cast<uint32_t*>(smem),
                               v4 + static_cast<size_t>(bh) * cells * 4 * d + g * kUnits * kPer,
                               cells, d);

  const int lg = lane >> 2, q = lane & 3, j = lg & 1;
  // Unit 2q + j first, then 2q + 1 - j: the quarter-warp's two rows read the
  // two halves of their cells' 128 bytes.
  const unsigned char* unit_a = smem + (2 * q + j) * 16;
  const unsigned char* unit_b = smem + (2 * q + 1 - j) * 16;
  for (int r0 = r_begin + warp * kWarpRows, slot = 0; r0 < r_end;
       r0 += kStep, slot = slot + 1 == kStages ? 0 : slot + 1) {
    cp_async_wait<kStages - 2>();  // this step's rows (this lane's copies)
    __syncwarp();                  // every lane's; the previous step's ring slot is free
    stage();
    const int n = min(kWarpRows, r_end - r0), rl = min(lg, n - 1);
    const unsigned char* st = ring + slot * kStageBytes;
    int id[4];
    float wq[1][4];  // slot q's weights of the row's points
    {
      const int4 iv = *reinterpret_cast<const int4*>(st + kWarpRows * 64 + rl * 16);
      const float4 wv = *reinterpret_cast<const float4*>(st + rl * 64 + q * 16);
      id[0] = iv.x, id[1] = iv.y, id[2] = iv.z, id[3] = iv.w;
      wq[0][0] = wv.x, wq[0][1] = wv.y, wq[0][2] = wv.z, wq[0][3] = wv.w;
    }
    int cell[4];
    float mine[1][4];
    merge<T, 4, 1>(id, wq, cells, cell, mine);
    float w[4][4];
    const int row_lane = lane & 28;
    if constexpr (sizeof(T) == 2) {
      // Rounded to bf16, two weights fit a word: lo the even point, hi the odd.
      uint32_t pk[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pk[h] = (__float_as_uint(mine[0][2 * h]) >> 16) |
                (__float_as_uint(mine[0][2 * h + 1]) & 0xffff0000u);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t u = __shfl_sync(0xffffffffu, pk[h], row_lane + s);
          w[s][2 * h] = __uint_as_float(u << 16);
          w[s][2 * h + 1] = __uint_as_float(u & 0xffff0000u);
        }
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) w[s][k] = __shfl_sync(0xffffffffu, mine[0][k], row_lane + s);
    }
    uint4 va[4], vb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      va[k] = *reinterpret_cast<const uint4*>(unit_a + cell[k] * kCellBytes);
      vb[k] = *reinterpret_cast<const uint4*>(unit_b + cell[k] * kCellBytes);
    }
    float a[kPer], b[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) a[c] = b[c] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float fa[kPer], fb[kPer];
        unit_floats(static_cast<T*>(nullptr), quad_word(va[k], s), fa);
        unit_floats(static_cast<T*>(nullptr), quad_word(vb[k], s), fb);
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          a[c] = fmaf(w[s][k], fa[c], a[c]);
          b[c] = fmaf(w[s][k], fb[c], b[c]);
        }
      }
    if (lg < n) {
      float lo[kPer], hi[kPer];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        lo[c] = j ? b[c] : a[c];
        hi[c] = j ? a[c] : b[c];
      }
      store_units(out + (head_row + r0 + lg) * d + (g * kUnits + 2 * q) * kPer, lo, hi);
    }
  }
  cp_async_wait<0>();
}

// ----------------------------------------------------------- L2 instance --
// A warp a (bh, query) row, two channels a lane, 64 channels a pass; the
// row's cells and merged weights in registers; per pass all 4P row pieces
// loaded before the first product. kD 64 (d known to the compiler: the
// slots' offsets fold into the loads) or 0 (d from the call).
template <typename T, int kP, int kD>
__global__ void __launch_bounds__(kRowThreads) onehot_l2_kernel(
    const T* __restrict__ v4, const int* __restrict__ idx, const float* __restrict__ wslot,
    T* __restrict__ out, int rows, int lq, int cells, int d_arg) {
  const int d = kD ? kD : d_arg;
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* table = v4 + static_cast<size_t>(r / lq) * cells * 4 * d;
  const float* ws = wslot + static_cast<size_t>(r) * 4 * kP;
  int id[kP];
  float wsv[4][kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) id[k] = idx[static_cast<size_t>(r) * kP + k];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int k = 0; k < kP; ++k) wsv[s][k] = ws[s * kP + k];
  float w[4][kP];
  int cell[kP];
  merge<T, kP, 4>(id, wsv, cells, cell, w);
  for (int c0 = 0; c0 < d; c0 += 64) {
    const int c = min(c0 + 2 * lane, d - 2);  // lanes past d read the last pair, store nothing
    float2 val[4][kP];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < kP; ++k)
        val[s][k] = load2(table + static_cast<size_t>(cell[k]) * 4 * d + s * d + c);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        acc0 = fmaf(w[s][k], val[s][k].x, acc0);
        acc1 = fmaf(w[s][k], val[s][k].y, acc1);
      }
    if (c0 + 2 * lane < d) store2(out + static_cast<size_t>(r) * d + c, acc0, acc1);
  }
}

// Shared memory of the shared-memory instance: the table and the warps' rings.
size_t smem_bytes(int cells) {
  return static_cast<size_t>(cells) * kCellBytes +
         static_cast<size_t>(kWarps) * kStages * kStageBytes;
}

template <typename T>
int launch_smem(const T* v4, const int* ix, const float* ws, T* out, int bh, int cells, int lq,
                int d, cudaStream_t s) {
  const DeviceInfo dev = device_info();
  const auto kernel = onehot_smem_kernel<T>;
  static bool opted_in = false;  // the limit, once an instance (one card a process)
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dev.smem_per_block);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int groups = d * static_cast<int>(sizeof(T)) / 32;
  const int pieces = (lq + kWarps * kWarpRows - 1) / (kWarps * kWarpRows);
  const int ranges = std::max(1, std::min(pieces, dev.sms / (bh * groups)));
  const int range_rows = (lq + ranges - 1) / ranges;
  onehot_smem_kernel<T><<<dim3(ranges, groups, bh), kWarps * 32, smem_bytes(cells), s>>>(
      v4, ix, ws, out, lq, cells, d, range_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kP>
int launch_l2(const T* v4, const int* ix, const float* ws, T* out, int bh, int cells, int lq,
              int d, cudaStream_t s) {
  const size_t rows = static_cast<size_t>(bh) * lq;
  const unsigned grid = static_cast<unsigned>((rows * 32 + kRowThreads - 1) / kRowThreads);
  const int n = static_cast<int>(rows);
  if (d == 64)
    onehot_l2_kernel<T, kP, 64><<<grid, kRowThreads, 0, s>>>(v4, ix, ws, out, n, lq, cells, d);
  else
    onehot_l2_kernel<T, kP, 0><<<grid, kRowThreads, 0, s>>>(v4, ix, ws, out, n, lq, cells, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_level(const T* v4, const int* ix, const float* ws, T* out, int bh, int cells, int lq,
                 int p, int d, cudaStream_t s) {
  const size_t limit = static_cast<size_t>(device_info().smem_per_block);
  if (p == 4 && smem_bytes(cells) <= limit)
    return launch_smem<T>(v4, ix, ws, out, bh, cells, lq, d, s);
  switch (p) {
    case 1: return launch_l2<T, 1>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 2: return launch_l2<T, 2>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 3: return launch_l2<T, 3>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 4: return launch_l2<T, 4>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 5: return launch_l2<T, 5>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 6: return launch_l2<T, 6>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 7: return launch_l2<T, 7>(v4, ix, ws, out, bh, cells, lq, d, s);
    case 8: return launch_l2<T, 8>(v4, ix, ws, out, bh, cells, lq, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// v4: (bh, cells, 4d) bf16 (bf16 != 0) or fp32; idx: (bh, lq, p) int32;
// wslot: (bh, lq, 4, p) fp32; out: (bh, lq, d) in v4's dtype; 1 <= p <= 8,
// d a multiple of 16 from 16 to 128; v4, idx and wslot 16-byte aligned.
extern "C" int iuvl_onehot_level_fwd(const void* v4, const void* idx, const void* wslot,
                                     void* out, int bh, int cells, int lq, int p, int d,
                                     int bf16_values, void* stream) {
  if (p < 1 || p > kMaxP || d < 16 || d > 128 || d % 16 || cells < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(bh) * lq == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  const auto* ws = static_cast<const float*>(wslot);
  if (bf16_values)
    return launch_level(static_cast<const bf16*>(v4), ix, ws, static_cast<bf16*>(out), bh, cells,
                        lq, p, d, s);
  return launch_level(static_cast<const float*>(v4), ix, ws, static_cast<float*>(out), bh, cells,
                      lq, p, d, s);
}
