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
// d (the head width) is a multiple of 16 from 16 to 128: lanes own fixed
// 8-channel pieces of a row, 64 channels a pass (lanes past d idle). The
// forward and the gather take kD = 64 (d known to the compiler: the rows'
// offsets fold into the loads, as in the first design) or 0 (d from the
// call); the scatter takes the pass count (1 up to d 64, else 2).
//
// Bounds on the card at the res3 level of a batch-2 train step (8 heads,
// hw 128^2, 21504 queries x 4 points; chip_smoke.py `work` computes them):
// all three move bytes and do few operations.
// - forward: v (bf16, 34 MB for two images), x, y, aw (fp32, 17 MB) in,
//   the fp32 (B, nh, Lq, 64) level output (88 MB) out: 0.041 ms. The
//   values stay in L2, so what bounds the kernel is latency: a query's 16
//   tap rows hang on its points' coordinates. A lane group of 8 serves a
//   query (4 a warp), a lane 8 channels: the group's lanes load and clip
//   one point each, share the tap rows and weights by shuffles, and issue
//   all 4P row loads (16 bytes a lane, a 128-byte row a group) before the
//   first multiply-add. Each channel sums in the parent's order (points,
//   then slots 0-3, acc += (w_s a) v in fp32), so the bits are the same;
//   P 4 is unrolled, any other P runs 8 points at a time.
// - gather: the rows g4 (R, 4d) = 352 MB bf16 per image out, from a 17 MB
//   map that stays in L2. A warp a row, 16 bytes a lane.
// - scatter: contrib (R, 4d) 352 MB in, d_value (nh, hw, d) fp32 out:
//   0.116 ms. No atomics, each cell summed in a fixed order, written once:
//   1. the rows sorted by (head, top-left cell) into a CSR, stably (rows of
//      a bucket in row order): an LSD radix sort of its own, passes of up
//      to 9 bits (2 at every level of the pixel decoder), each pass a count
//      a block (a warp's rows ranked by __match_any_sync), one exclusive
//      scan, and a stable placement; then each bucket's start.
//   2. a warp a destination cell, a lane group a slot plane: group s sums
//      plane s of the bucket at (cell - off_s) mod hw, its rows in order in
//      fp32, 8 row loads in flight a lane (the next 8 row indices loaded
//      ahead); the four sums are folded in JAX's order (S0 + S1 + S2 + S3)
//      and the cell is written once, zero when empty (the wrapper hands
//      torch.empty).
//   3. a bucket of more than kChunk (256) rows is summed in pieces: a warp
//      a kChunk-row piece of the sorted order sums the runs of long buckets
//      at its two ends into a partial, and the cell's group adds its
//      bucket's partials in order. The work of a warp stays bounded when a
//      head's rows crowd into a few cells.
//   The plain version (ops/cuda/msdeform.py) sums in the same order.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kPass = 64;  // channels a lane group covers in one pass, 8 a lane

int passes_of(int d) { return d > kPass ? 2 : 1; }

// This lane's first channel in the pass from c0 and whether it is a real
// one: lanes past d read the pass's last piece and store nothing.
__device__ __forceinline__ int pass_col(int c0, int sub, int d) { return min(c0 + 8 * sub, d - 8); }
__device__ __forceinline__ bool pass_live(int c0, int sub, int d) { return c0 + 8 * sub < d; }

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

// Lane l of a row's group of 8 owns channels c0 + 8 (l % 8) .. + 7 of a
// pass: 8 elements, one 16-byte piece in bf16, two in fp32.
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

// ------------------------------------------------------------- forward --
// kN points of the group's query, point j's top-left index and folded slot
// weights held by the group's lane src0 + j: their 4 kN tap rows loaded,
// then acc[c] += wa[j][s] * v[row(j, s)][c] in point, then slot, order.
template <typename T, int kN>
__device__ __forceinline__ void fwd_points(float (&acc)[8], const T* map, int idx,
                                           const float (&wa)[4], int src0, int w, int hw,
                                           int d) {
  float wt[kN][4];
  Piece<T> val[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int ij = __shfl_sync(0xffffffffu, idx, src0 + j);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wt[j][s] = __shfl_sync(0xffffffffu, wa[s], src0 + j);
      val[j][s] = load_piece(map + static_cast<size_t>(tap_row(ij, s, w, hw)) * d);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float f[8];
      piece_floats(val[j][s], f);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += wt[j][s] * f[c];
    }
}

// out[b, h, q, :] = sum over points k and slots s of wa[k, s] * v[b, h, row(k, s), :].
// A group of 8 lanes a query, 64 channels a pass; kP: the points (4,
// unrolled), or 0 for any P, 8 points at a time, one point's rows in
// flight at once. The groups of a query past `total` follow the last query
// and store nothing (the shuffles take the whole warp).
template <typename T, int kP, int kD>
__global__ void __launch_bounds__(256) level_fwd_kernel(
    const T* __restrict__ v, const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ aw, float* __restrict__ out, int total, int lq, int p, int h,
    int w, int d_arg) {
  const int q = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3);
  const int lane = threadIdx.x & 31, sub = lane & 7, src0 = lane & 24;
  const int qq = min(q, total - 1), np = kP ? kP : p, hw = h * w, d = kD ? kD : d_arg;
  const size_t pt = static_cast<size_t>(qq) * np;
  for (int c0 = 0; c0 < d; c0 += kPass) {
    const int c = pass_col(c0, sub, d);
    const T* map = v + static_cast<size_t>(qq / lq) * hw * d + c;
    float acc[8] = {};
    for (int k0 = 0; k0 < np; k0 += 8) {
      int idx = 0;
      float wa[4] = {};
      if (k0 + sub < np) {  // lane sub clips point k0 + sub
        const WideTaps t = wide_taps(x[pt + k0 + sub], y[pt + k0 + sub], h, w);
        const float a = aw[pt + k0 + sub];
        idx = t.idx;
#pragma unroll
        for (int s = 0; s < 4; ++s) wa[s] = t.w[s] * a;
      }
      if (kP) {
        fwd_points<T, kP ? kP : 1>(acc, map, idx, wa, src0, w, hw, d);
      } else {
        for (int j = 0; j < min(8, np - k0); ++j)
          fwd_points<T, 1>(acc, map, idx, wa, src0 + j, w, hw, d);
      }
    }
    if (q < total && pass_live(c0, sub, d)) {
      float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(q) * d + c);
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

// -------------------------------------------------------------- gather --
// g4[r, d s + c] = v[head(r), row(idx[r], s), c]: a warp a row, lane l
// slot l / 8, channels 8 (l % 8) + 64 i .. + 7.
template <typename T, int kD>
__global__ void gather_kernel(const T* __restrict__ v, const int* __restrict__ idx,
                              T* __restrict__ g4, int rows, int per_head, int hw, int w,
                              int d_arg) {
  const int d = kD ? kD : d_arg;
  const int r = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                  threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int slot = lane >> 3;
  const T* src = v + (static_cast<size_t>(r / per_head) * hw + tap_row(idx[r], slot, w, hw)) * d;
  T* dst = g4 + static_cast<size_t>(r) * 4 * d + slot * d;
  for (int c = 8 * (lane & 7); c < d; c += kPass) {
    const Piece<T> pc = load_piece(src + c);
#pragma unroll
    for (int k = 0; k < Piece<T>::kVecs; ++k) reinterpret_cast<uint4*>(dst + c)[k] = pc.u[k];
  }
}

// ------------------------------------------------------------- scatter --
constexpr int kSortWarps = 8;                          // a sort block's warps
constexpr int kSortWarpRows = 256;                     // rows a warp ranks, 32 a round
constexpr int kSortTile = kSortWarps * kSortWarpRows;  // rows a sort block
constexpr int kMaxDigitBits = 9;                       // bits a pass: 512 bins at most
constexpr int kChunk = 256;                            // rows of a long bucket's piece

// A row's sort key on the first pass (head * hw + top-left cell; the row is
// its own index), else the previous pass's output.
template <bool kFirst>
__device__ __forceinline__ int sort_key(const int* keys, const int* idx, int i, int per_head,
                                        int hw) {
  return kFirst ? (i / per_head) * hw + idx[i] : keys[i];
}

// cnt[warp][bin]: the warp's rows of the block's tile with each digit, 32
// rows a round in row order, each group of equal digits counted by its
// first lane. Returns nothing; the block syncs after.
template <bool kFirst>
__device__ __forceinline__ void warp_digit_counts(int (*cnt)[1 << kMaxDigitBits],
                                                  const int* keys, const int* idx, int rows,
                                                  int per_head, int hw, int shift, int mask) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kSortTile + warp * kSortWarpRows;
  for (int i = 0; i < kSortWarpRows; i += 32) {
    const int r = r0 + i + lane;
    const int dg = r < rows ? (sort_key<kFirst>(keys, idx, r, per_head, hw) >> shift) & mask : -1;
    const unsigned m = __match_any_sync(0xffffffffu, dg);
    if (dg >= 0 && lane == __ffs(m) - 1) cnt[warp][dg] += __popc(m);
    __syncwarp();
  }
}

// hist[bin * tiles + tile]: the tile's rows with each digit.
template <bool kFirst>
__global__ void __launch_bounds__(kSortWarps * 32) sort_count_kernel(
    const int* __restrict__ keys, const int* __restrict__ idx, int* __restrict__ hist, int rows,
    int per_head, int hw, int shift, int bins) {
  __shared__ int cnt[kSortWarps][1 << kMaxDigitBits];
  for (int i = threadIdx.x; i < kSortWarps * bins; i += blockDim.x) cnt[i / bins][i % bins] = 0;
  __syncthreads();
  warp_digit_counts<kFirst>(cnt, keys, idx, rows, per_head, hw, shift, bins - 1);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    int sum = 0;
#pragma unroll
    for (int wp = 0; wp < kSortWarps; ++wp) sum += cnt[wp][b];
    hist[b * gridDim.x + blockIdx.x] = sum;
  }
}

// Each bin's row of hist (its tiles' counts) scanned in place, exclusive,
// and the row's total into totals[bin]: a warp a bin, 8 tiles a lane a
// round, all its loads issued at once.
__global__ void __launch_bounds__(256) sort_scan_kernel(int* __restrict__ hist,
                                                        int* __restrict__ totals, int bins,
                                                        int tiles) {
  const int bin = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                    threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (bin >= bins) return;
  int* row = hist + static_cast<size_t>(bin) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += 256) {
    int v[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + 8 * lane + j;
      v[j] = t < tiles ? row[t] : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += v[j];
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += up;
    }
    int run = carry + inc - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = t0 + 8 * lane + j;
      if (t < tiles) row[t] = run;
      run += v[j];
    }
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) totals[bin] = carry;
}

// One stable counting pass: each row to the rows of smaller digits (the
// bins' totals, scanned here), plus its digit's rows in earlier tiles
// (hist, scanned), plus its tile's rows before it with that digit (earlier
// warps, then earlier rounds of its warp, then lower lanes).
template <bool kFirst>
__global__ void __launch_bounds__(kSortWarps * 32) sort_place_kernel(
    const int* __restrict__ keys, const int* __restrict__ order, const int* __restrict__ idx,
    const int* __restrict__ hist, const int* __restrict__ totals, int* __restrict__ keys_out,
    int* __restrict__ order_out, int rows, int per_head, int hw, int shift, int bins) {
  __shared__ int cnt[kSortWarps][1 << kMaxDigitBits];
  __shared__ int base[1 << kMaxDigitBits];
  __shared__ int warp_sums[kSortWarps];
  for (int i = threadIdx.x; i < kSortWarps * bins; i += blockDim.x) cnt[i / bins][i % bins] = 0;
  {  // base[b] = the totals of the bins below b: two bins a thread
    constexpr int kPer = (1 << kMaxDigitBits) / (kSortWarps * 32);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b0 = kPer * threadIdx.x;
    int v[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = b0 + j < bins ? totals[b0 + j] : 0;
      sum += v[j];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += up;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    int run = inc - sum;
    for (int wp = 0; wp < warp; ++wp) run += warp_sums[wp];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      base[b0 + j] = run;
      run += v[j];
    }
  }
  __syncthreads();
  warp_digit_counts<kFirst>(cnt, keys, idx, rows, per_head, hw, shift, bins - 1);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    int run = base[b] + hist[b * gridDim.x + blockIdx.x];
#pragma unroll
    for (int wp = 0; wp < kSortWarps; ++wp) {
      const int c = cnt[wp][b];
      cnt[wp][b] = run;
      run += c;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kSortTile + warp * kSortWarpRows;
  for (int i = 0; i < kSortWarpRows; i += 32) {
    const int r = r0 + i + lane;
    const int key = r < rows ? sort_key<kFirst>(keys, idx, r, per_head, hw) : 0;
    const int dg = r < rows ? (key >> shift) & (bins - 1) : -1;
    const unsigned m = __match_any_sync(0xffffffffu, dg);
    const int pos = dg >= 0 ? cnt[warp][dg] + __popc(m & ((1u << lane) - 1)) : 0;
    __syncwarp();
    if (dg >= 0 && lane == __ffs(m) - 1) cnt[warp][dg] += __popc(m);
    __syncwarp();
    if (dg >= 0) {
      keys_out[pos] = key;
      order_out[pos] = kFirst ? r : order[r];
    }
  }
}

// start[k] = the first position of the sorted keys at or past bucket k,
// for k in [0, buckets]: a binary search a bucket.
__global__ void bucket_start_kernel(const int* __restrict__ keys, int* __restrict__ start,
                                    int rows, int buckets) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k > buckets) return;
  int lo = 0, hi = rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  start[k] = lo;
}

// acc += columns col .. + 7 of the rows (of width 4d) at sorted positions
// [a, b), in order: the group's 8 lanes take 8 positions' row indices at a
// time (the next 8 fetched before this batch's rows) and load those rows'
// pieces before adding them. gmask: the group's lanes.
template <typename T>
__device__ __forceinline__ void sum_rows(float (&acc)[8], const T* contrib, const int* order,
                                         int a, int b, int d, int col, int sub, unsigned gmask) {
  int next = a + sub < b ? order[a + sub] : 0;
  for (int p0 = a; p0 < b; p0 += 8) {
    const int n = min(8, b - p0), mine = next;
    next = p0 + 8 + sub < b ? order[p0 + 8 + sub] : 0;
    Piece<T> val[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = __shfl_sync(gmask, mine, u, 8);
      if (u < n) val[u] = load_piece(contrib + static_cast<size_t>(r) * 4 * d + col);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (u < n) {
        float f[8];
        piece_floats(val[u], f);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] += f[c];
      }
    }
  }
}

// A warp a piece (kChunk positions) of the sorted order: the sums of the
// runs at its two ends that belong to long buckets (more than kChunk
// rows), all four planes: part[piece][0] its first run's, part[piece][1]
// its last run's where that is another bucket.
template <typename T, int kPasses>
__global__ void __launch_bounds__(256, 3) dv_piece_kernel(
    const T* __restrict__ contrib, const int* __restrict__ keys, const int* __restrict__ order,
    const int* __restrict__ start, float* __restrict__ part, int rows, int d) {
  const int piece = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                      threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31, plane = lane >> 3, sub = lane & 7;
  const int p0 = piece * kChunk;
  if (p0 >= rows) return;
  const int p1 = min(rows, p0 + kChunk);
  const int kf = keys[p0], kl = keys[p1 - 1];
  for (int end = 0; end < 2; ++end) {
    const int k = end ? kl : kf;
    if (end && kl == kf) break;
    const int s0 = start[k], s1 = start[k + 1];
    if (s1 - s0 <= kChunk) continue;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int c0 = pass * kPass, c = pass_col(c0, sub, d);
      float acc[8] = {};
      sum_rows(acc, contrib, order, max(p0, s0), min(p1, s1), d, plane * d + c, sub,
               0xffu << (lane & 24));
      if (pass_live(c0, sub, d)) {
        float4* o = reinterpret_cast<float4*>(
            part + (static_cast<size_t>(piece) * 2 + end) * 4 * d + plane * d + c);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
  }
}

// dv[head, c] = S0[c] + S1[c - 1] + S2[c - w] + S3[c - w - 1] (cells mod
// hw): a warp a (head, cell), group s summing plane s of its bucket (the
// rows, or a long bucket's pieces' partials, in order), the four sums
// folded left to right in lanes 0-7, which write the cell's 4d bytes of
// the pass (64 channels a pass).
template <typename T, int kPasses>
__global__ void __launch_bounds__(256, 4) dv_cell_kernel(
    const T* __restrict__ contrib, const int* __restrict__ order, const int* __restrict__ start,
    const float* __restrict__ part, float* __restrict__ dv, int cells, int hw, int w, int d) {
  const int cell = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x +
                                     threadIdx.x) >> 5);
  if (cell >= cells) return;
  const int lane = threadIdx.x & 31, plane = lane >> 3, sub = lane & 7;
  const int head = cell / hw, pos = cell % hw;
  const int off = (plane & 1) + (plane >> 1) * w;
  const int k = head * hw + ((pos - off) % hw + hw) % hw;
  const int s0 = start[k], s1 = start[k + 1];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int c0 = pass * kPass, c = pass_col(c0, sub, d);
    float acc[8] = {};
    if (s1 - s0 <= kChunk) {
      sum_rows(acc, contrib, order, s0, s1, d, plane * d + c, sub, 0xffu << (lane & 24));
    } else {
      // The bucket's last run in piece i0 unless it starts the piece, then
      // the first run of each later piece it reaches.
      const int i0 = s0 / kChunk, i1 = (s1 - 1) / kChunk;
      for (int i = i0; i <= i1; ++i) {
        const int end = i == i0 && s0 != i0 * kChunk ? 1 : 0;
        const float4* pp = reinterpret_cast<const float4*>(
            part + (static_cast<size_t>(i) * 2 + end) * 4 * d + plane * d + c);
        const float4 lo = pp[0], hi = pp[1];
        acc[0] += lo.x, acc[1] += lo.y, acc[2] += lo.z, acc[3] += lo.w;
        acc[4] += hi.x, acc[5] += hi.y, acc[6] += hi.z, acc[7] += hi.w;
      }
    }
    float sum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float s1v = __shfl_down_sync(0xffffffffu, acc[j], 8);
      const float s2v = __shfl_down_sync(0xffffffffu, acc[j], 16);
      const float s3v = __shfl_down_sync(0xffffffffu, acc[j], 24);
      sum[j] = acc[j] + s1v;
      sum[j] += s2v;
      sum[j] += s3v;
    }
    if (plane == 0 && pass_live(c0, sub, d)) {
      float4* o = reinterpret_cast<float4*>(dv + static_cast<size_t>(cell) * d + c);
      o[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
      o[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
    }
  }
}

constexpr int kRowThreads = 256;  // 8 warps a block

unsigned blocks_for(size_t threads) {
  return static_cast<unsigned>((threads + kRowThreads - 1) / kRowThreads);
}

template <typename T>
int fwd_launch(const T* v, const float* x, const float* y, const float* aw, float* out,
               size_t total, int lq, int p, int h, int w, int d, cudaStream_t s) {
  const unsigned grid = blocks_for(total * 8);
  const int n = static_cast<int>(total);
  if (p == 4 && d == kPass)
    level_fwd_kernel<T, 4, kPass><<<grid, kRowThreads, 0, s>>>(v, x, y, aw, out, n, lq, p, h, w, d);
  else if (p == 4)
    level_fwd_kernel<T, 4, 0><<<grid, kRowThreads, 0, s>>>(v, x, y, aw, out, n, lq, p, h, w, d);
  else if (d == kPass)
    level_fwd_kernel<T, 0, kPass><<<grid, kRowThreads, 0, s>>>(v, x, y, aw, out, n, lq, p, h, w, d);
  else
    level_fwd_kernel<T, 0, 0><<<grid, kRowThreads, 0, s>>>(v, x, y, aw, out, n, lq, p, h, w, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather_launch(const T* v, const int* idx, T* g4, size_t rows, int per_head, int hw, int w,
                  int d, cudaStream_t s) {
  const unsigned grid = blocks_for(rows * 32);
  const int n = static_cast<int>(rows);
  if (d == kPass)
    gather_kernel<T, kPass><<<grid, kRowThreads, 0, s>>>(v, idx, g4, n, per_head, hw, w, d);
  else
    gather_kernel<T, 0><<<grid, kRowThreads, 0, s>>>(v, idx, g4, n, per_head, hw, w, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter_run(const T* contrib, const int* idx, float* dv, int* ws, int* start, float* part,
                int nh, int per_head, int hw, int w, int d, int digit_bits, int passes,
                cudaStream_t s) {
  const int rows = nh * per_head, buckets = nh * hw, bins = 1 << digit_bits;
  const int tiles = (rows + kSortTile - 1) / kSortTile;
  int* keys[2] = {ws, ws + 2 * static_cast<size_t>(rows)};
  int* order[2] = {ws + rows, ws + 3 * static_cast<size_t>(rows)};
  int* hist = ws + 4 * static_cast<size_t>(rows);
  int* totals = hist + static_cast<size_t>(bins) * tiles;
  const unsigned scan_grid = blocks_for(static_cast<size_t>(bins) * 32);
  int cur = 0;
  if (rows > 0) {
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = pass * digit_bits, out = pass & 1;
      if (pass == 0) {
        sort_count_kernel<true><<<tiles, kSortWarps * 32, 0, s>>>(nullptr, idx, hist, rows,
                                                                  per_head, hw, shift, bins);
        sort_scan_kernel<<<scan_grid, kRowThreads, 0, s>>>(hist, totals, bins, tiles);
        sort_place_kernel<true><<<tiles, kSortWarps * 32, 0, s>>>(
            nullptr, nullptr, idx, hist, totals, keys[out], order[out], rows, per_head, hw, shift,
            bins);
      } else {
        sort_count_kernel<false><<<tiles, kSortWarps * 32, 0, s>>>(keys[cur], idx, hist, rows,
                                                                   per_head, hw, shift, bins);
        sort_scan_kernel<<<scan_grid, kRowThreads, 0, s>>>(hist, totals, bins, tiles);
        sort_place_kernel<false><<<tiles, kSortWarps * 32, 0, s>>>(
            keys[cur], order[cur], idx, hist, totals, keys[out], order[out], rows, per_head, hw,
            shift, bins);
      }
      cur = out;
    }
  }
  bucket_start_kernel<<<blocks_for(static_cast<size_t>(buckets) + 1), kRowThreads, 0, s>>>(
      keys[cur], start, rows, buckets);
  const int pieces = (rows + kChunk - 1) / kChunk;
  const unsigned piece_grid = blocks_for(static_cast<size_t>(pieces) * 32);
  const unsigned cell_grid = blocks_for(static_cast<size_t>(buckets) * 32);
  if (passes_of(d) == 1) {
    if (pieces > 0)
      dv_piece_kernel<T, 1><<<piece_grid, kRowThreads, 0, s>>>(contrib, keys[cur], order[cur],
                                                               start, part, rows, d);
    dv_cell_kernel<T, 1><<<cell_grid, kRowThreads, 0, s>>>(contrib, order[cur], start, part, dv,
                                                           buckets, hw, w, d);
  } else {
    if (pieces > 0)
      dv_piece_kernel<T, 2><<<piece_grid, kRowThreads, 0, s>>>(contrib, keys[cur], order[cur],
                                                               start, part, rows, d);
    dv_cell_kernel<T, 2><<<cell_grid, kRowThreads, 0, s>>>(contrib, order[cur], start, part, dv,
                                                           buckets, hw, w, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The head widths the kernels take: multiples of 16 from 16 to 128.
bool width_ok(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// v: (B, nh, h*w, d) bf16 (bf16 != 0) or fp32; x, y, aw: (B, nh, lq, p) fp32
// pixel coordinates and attention weights; out: (B, nh, lq, d) fp32.
extern "C" int iuvl_msdeform_fwd(const void* v, const void* x, const void* y, const void* aw,
                                 void* out, int b, int nh, int lq, int p, int h, int w, int d,
                                 int bf16_values, void* stream) {
  if (p < 1 || !width_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(b) * nh * lq;
  if (total == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* af = static_cast<const float*>(aw);
  auto* o = static_cast<float*>(out);
  return bf16_values
             ? fwd_launch(static_cast<const bf16*>(v), xf, yf, af, o, total, lq, p, h, w, d, s)
             : fwd_launch(static_cast<const float*>(v), xf, yf, af, o, total, lq, p, h, w, d, s);
}

// One image: v (nh, hw, d); idx (nh, per_head) int32 top-left rows in
// [0, hw); g4 (nh * per_head, 4d) in v's type.
extern "C" int iuvl_deform_gather(const void* v, const void* idx, void* g4, int nh, int per_head,
                                  int hw, int w, int d, int bf16_values, void* stream) {
  if (!width_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(nh) * per_head;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  return bf16_values ? gather_launch(static_cast<const bf16*>(v), ix, static_cast<bf16*>(g4),
                                     rows, per_head, hw, w, d, s)
                     : gather_launch(static_cast<const float*>(v), ix, static_cast<float*>(g4),
                                     rows, per_head, hw, w, d, s);
}

// One image: contrib (nh * per_head, 4d) bf16 or fp32; idx as for the
// gather; dv (nh, hw, d) fp32, every cell written. Workspaces from the
// wrapper (ops/cuda/msdeform.py scatter_plan): ws int32, two key and two
// row arrays of nh * per_head, then the counts of (2^digit_bits bins) x
// (one a 2048-row tile) and the bins' totals; start int32 (nh * hw + 1);
// part fp32 (pieces of 256 sorted rows, 2, 4d). `passes` radix passes of
// `digit_bits` bits (at most 9) cover the keys head * hw + cell.
extern "C" int iuvl_deform_scatter(const void* contrib, const void* idx, void* dv, void* ws,
                                   void* start, void* part, int nh, int per_head, int hw, int w,
                                   int d, int digit_bits, int passes, int bf16_values,
                                   void* stream) {
  if (nh < 1 || hw < 1 || per_head < 0 || !width_ok(d) || digit_bits < 1 ||
      digit_bits > kMaxDigitBits ||
      passes < 1 || (static_cast<long long>(nh) * hw - 1) >> (digit_bits * passes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(dv);
  auto* wsi = static_cast<int*>(ws);
  auto* st = static_cast<int*>(start);
  auto* pt = static_cast<float*>(part);
  return bf16_values
             ? scatter_run(static_cast<const bf16*>(contrib), ix, o, wsi, st, pt, nh, per_head,
                           hw, w, d, digit_bits, passes, s)
             : scatter_run(static_cast<const float*>(contrib), ix, o, wsi, st, pt, nh, per_head,
                           hw, w, d, digit_bits, passes, s);
}
