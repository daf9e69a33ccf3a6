// Tap-row scatter-add of the point-sample backward (B12):
//   acc[n, base[n, p], :] += rows[n, p, :]   (4 fp32 taps per row)
// into a zeroed (N, span, 4) table. Replaces
// iuvl_tpu/ops/pallas/tap_scatter.py:tap_scatter.
//
// Bound on the card: bytes. The work is N*P rows of 16 bytes and their
// int32 cells in, and the (N, span, 4) fp32 table out (20 x 12544 rows and
// a 20 x 65,793-cell table at the criterion's shapes: 5 MB in, 21 MB out),
// no arithmetic to speak of. So the table is written once, by one launch,
// with no zero-fill pass and no read-modify-write of device memory.
//
// The TPU kernel kept one map's table in VMEM, zeroed it and walked the
// rows in a serial loop. A map's table (65,793 cells x 16 B = 1 MB) does not
// fit a block's shared memory, so the grid is (slab, map): a block owns a
// slab of S consecutive cells of one map in shared memory (S from the span
// and the SM count: one wave of two blocks an SM), zeroes it, adds the
// map's rows that fall in it, and writes the slab out with coalesced
// 16-byte stores. Every block reads all its map's cells (int32, three
// batches of 2048 ahead in registers), and the rows that fall in its slab
// are appended, in row order, to a list in shared memory (ballots and the
// warps' counts). When the list is full or the rows end, the block buckets
// the entries by owner warp (cell mod 8) in list order, and warp w adds its
// bucket 32 entries at a time (16-byte tap loads of 4 such groups in
// flight): a byte a cell of tags finds the cells that more than one of the
// 32 lanes hit; the rest add at once, the shared cells' lanes find each
// other a cell at a time (a broadcast and a ballot), and each shared cell's
// first lane adds its lanes' taps in lane order. So each cell sums its
// rows in row order, as the TPU kernel's serial loop does: the same bits
// from launch to launch. (A shared-memory atomic add would be order-free
// only for cells of at most two rows: at the criterion's shape 1,341 cells
// get three or more.)
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kTJ = 8;                       // cells a thread reads a batch
constexpr int kTBatch = kTJ * kThreads;      // rows a batch
constexpr int kTCap = kTBatch;               // list entries
constexpr int kTSeg = kTCap / kWarps / 32;   // a warp's share of the list, in 32s
constexpr int kTAhead = 4;                   // a warp's bucket groups with rows in flight

struct TapSmem {
  static constexpr size_t kFixed = 2 * kTCap * sizeof(int) + 4 * kTJ * kWarps * sizeof(int) +
                                   kThreads * sizeof(float4) + 16;
  // The slab (16 bytes a cell) and a byte a cell of collision tags.
  static size_t bytes(int cells) {
    return kFixed + static_cast<size_t>(cells) * sizeof(float4) + (cells + 15) / 16 * 16;
  }
};

__global__ void __launch_bounds__(kThreads, 2) tap_scatter_kernel(
    const int* __restrict__ base, const float4* __restrict__ rows, float4* __restrict__ acc,
    int p, int span, int slab) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* lrow = reinterpret_cast<int*>(smem);  // the list: row in the map
  int* lcell = lrow + kTCap;                 //           cell in the slab, then buckets
  int* wtot = lcell + kTCap;                 // [2][kWarps] batch counts (+ spare)
  int* ocnt = wtot + 2 * kTJ * kWarps;       // [warp][owner] counts
  int* obase = ocnt + kWarps * kWarps;       // [owner][warp] bucket offsets
  float4* sslab = reinterpret_cast<float4*>(smem + TapSmem::kFixed);
  unsigned char* tag = reinterpret_cast<unsigned char*>(sslab + slab);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4* sgroup = reinterpret_cast<float4*>(obase + kWarps * kWarps) + warp * 32;  // its taps
  const int n = blockIdx.y, c0 = blockIdx.x * slab, cells = min(slab, span - c0);
  if (cells <= 0) return;
  const int* bm = base + static_cast<size_t>(n) * p;
  const float4* rm = rows + static_cast<size_t>(n) * p;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < cells; i += kThreads) sslab[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // Adds list entries [0, m) to the slab: the entries are bucketed by owner
  // warp (cell mod 8), each bucket in list order, and each warp adds its
  // bucket 32 entries at a time, the taps of kTAhead groups in flight: the
  // lanes whose cells no other lane of the 32 has add at once, the others
  // one lane after another in lane order.
  auto flush = [&](int m) {
    __syncthreads();  // the list is written
    // Each warp ranks its segment of the list by owner, in list order; lane
    // k < 8 keeps the warp's running count of owner k.
    const int seg = (m + kWarps - 1) / kWarps, s0 = warp * seg, s1 = min(m, s0 + seg);
    int own[kTSeg], rank[kTSeg], entv[kTSeg], count = 0;
#pragma unroll
    for (int gi = 0; gi < kTSeg; ++gi) {
      const int e = s0 + 32 * gi + lane;
      const bool valid = e < s1;
      const int cell = valid ? lcell[e] : 0, o = cell & (kWarps - 1);
      entv[gi] = e << 16 | cell;
      own[gi] = valid ? o : -1;
      const unsigned bv = __ballot_sync(0xffffffffu, valid);
      const unsigned b0 = __ballot_sync(0xffffffffu, o & 1), b1 = __ballot_sync(0xffffffffu, o & 2),
                     b2 = __ballot_sync(0xffffffffu, o & 4);
      // The lanes whose owner is k: for this lane's owner, and for owner
      // (lane & 7) to update that lane's count.
      auto same = [&](int k) {
        return bv & (k & 1 ? b0 : ~b0) & (k & 2 ? b1 : ~b1) & (k & 4 ? b2 : ~b2);
      };
      rank[gi] = __shfl_sync(0xffffffffu, count, o) + __popc(same(o) & below);
      count += __popc(same(lane & (kWarps - 1)));
    }
    if (lane < kWarps) ocnt[warp * kWarps + lane] = count;
    __syncthreads();  // also: the cells are read (the buckets go in their place)
    if (warp == 0) {  // bucket offsets in (owner, warp) order
      const int e0 = 2 * lane, e1 = 2 * lane + 1;
      const int v0 = ocnt[(e0 % kWarps) * kWarps + e0 / kWarps];
      const int v1 = ocnt[(e1 % kWarps) * kWarps + e1 / kWarps];
      int inc = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += x;
      }
      obase[e0] = inc - v0 - v1;
      obase[e1] = inc - v1;
    }
    __syncthreads();
    int* bucket = lcell;  // (list index << 16) | cell, by owner
#pragma unroll
    for (int gi = 0; gi < kTSeg; ++gi)
      if (own[gi] >= 0) bucket[obase[own[gi] * kWarps + warp] + rank[gi]] = entv[gi];
    __syncthreads();
    const int b0 = obase[warp * kWarps], b1 = warp + 1 < kWarps ? obase[(warp + 1) * kWarps] : m;
    for (int g0 = b0; g0 < b1; g0 += kTAhead * 32) {
      int ent[kTAhead];
      float4 d[kTAhead];
#pragma unroll
      for (int u = 0; u < kTAhead; ++u) {
        const int e = g0 + 32 * u + lane;
        ent[u] = e < b1 ? bucket[e] : -1;
        if (ent[u] >= 0) d[u] = __ldg(rm + lrow[ent[u] >> 16]);
      }
#pragma unroll
      for (int u = 0; u < kTAhead; ++u) {
        if (g0 + 32 * u >= b1) break;
        const bool valid = ent[u] >= 0;
        const int cell = ent[u] & 0xffff;
        if (valid) tag[cell] = static_cast<unsigned char>(lane);
        __syncwarp();
        const bool lost = valid && tag[cell] != lane;
        __syncwarp();
        if (lost) tag[cell] |= 0x80;  // the cell has more than one lane here
        __syncwarp();
        const bool shared = valid && (tag[cell] & 0x80);
        if (valid && !shared) {
          float4 a = sslab[cell];
          a.x += d[u].x, a.y += d[u].y, a.z += d[u].z, a.w += d[u].w;
          sslab[cell] = a;
        }
        // The shared cells: each lane's peers (a broadcast of each such
        // lane's cell), and the first of them adds their taps in lane order.
        const unsigned involved = __ballot_sync(0xffffffffu, shared);
        if (involved) {
          if (shared) sgroup[lane] = d[u];
          // A shared cell a round: the lowest lane left broadcasts its cell
          // and a ballot finds that cell's lanes.
          unsigned peers = 0;
          for (unsigned rest = involved; rest;) {
            const int c = __shfl_sync(0xffffffffu, cell, __ffs(rest) - 1);
            const unsigned same = __ballot_sync(0xffffffffu, shared && cell == c);
            if (cell == c) peers = same;
            rest &= ~same;
          }
          __syncwarp();
          if (shared && !(peers & below)) {
            float4 a = sslab[cell];
            for (unsigned rest = peers; rest; rest &= rest - 1) {  // in lane order
              const float4 x = sgroup[__ffs(rest) - 1];
              a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
            }
            sslab[cell] = a;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();  // the list's space and the slab's sums are settled
  };

  // The map's cells, a batch of kTJ a lane (warp w of batch b: rows
  // [b kTBatch + w 32 kTJ, ...), 32 consecutive a load), in four register
  // sets: the batch three ahead of the one being listed is in flight, and
  // no set is copied to another (a copy would wait for its loads).
  auto row_of = [&](int b, int j) { return b * kTBatch + (warp * kTJ + j) * 32 + lane; };
  auto fetch = [&](int (&dst)[kTJ], int b) {
#pragma unroll
    for (int j = 0; j < kTJ; ++j) {
      const int r = row_of(b, j);
      dst[j] = r < p ? bm[r] : -1;
    }
  };
  int len = 0;
  // Appends batch b's rows that fall in the slab to the list, in row order
  // (warp-major within the batch).
  auto list_batch = [&](const int (&cur)[kTJ], int b) {
    unsigned mask[kTJ];
    int off[kTJ], wsum = 0;
#pragma unroll
    for (int j = 0; j < kTJ; ++j) {
      mask[j] = __ballot_sync(0xffffffffu, static_cast<unsigned>(cur[j] - c0) <
                                               static_cast<unsigned>(cells));
      off[j] = wsum;
      wsum += __popc(mask[j]);
    }
    int* tot = wtot + (b & 1) * kWarps;  // two sets: one barrier a batch
    if (lane == 0) tot[warp] = wsum;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = tot[w];
      total += v;
      before += w < warp ? v : 0;
    }
    if (len + total > kTCap) {
      flush(len);
      len = 0;
    }
#pragma unroll
    for (int j = 0; j < kTJ; ++j) {
      if (mask[j] >> lane & 1u) {
        const int at = len + before + off[j] + __popc(mask[j] & below), r = row_of(b, j);
        lrow[at] = r;
        lcell[at] = cur[j] - c0;
      }
    }
    len += total;
  };
  const int batches = (p + kTBatch - 1) / kTBatch;
  int set0[kTJ], set1[kTJ], set2[kTJ], set3[kTJ];
  fetch(set0, 0);
  fetch(set1, 1);
  fetch(set2, 2);
  for (int b = 0; b < batches; b += 4) {
    fetch(set3, b + 3);
    list_batch(set0, b);
    if (b + 1 >= batches) break;
    fetch(set0, b + 4);
    list_batch(set1, b + 1);
    if (b + 2 >= batches) break;
    fetch(set1, b + 5);
    list_batch(set2, b + 2);
    if (b + 3 >= batches) break;
    fetch(set2, b + 6);
    list_batch(set3, b + 3);
  }
  if (len > 0) flush(len);
  __syncthreads();
  float4* out = acc + static_cast<size_t>(n) * span + c0;
  for (int i = tid; i < cells; i += kThreads) out[i] = sslab[i];
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// base: (N, P) int32 (rows outside [0, span) are dropped); rows: (N, P, 4)
// fp32; acc: (N, span, 4) fp32, every cell written (no zeroing needed).
extern "C" int iuvl_tap_scatter(const void* base, const void* rows, void* acc, int n, int p,
                                int span, void* stream) {
  if (n < 0 || p < 0 || span < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const DeviceInfo dev = device_info();
  const int sms = dev.sms, per_sm = dev.smem_per_sm;
  // The largest slab two blocks an SM hold (1 KB an SM block reserved), and
  // enough slabs that the grid fills the card once.
  const int max_cells =
      ((per_sm / 2 - 1024 - static_cast<int>(TapSmem::kFixed) - 32) / 17) / 8 * 8;
  int slabs = (span + max_cells - 1) / max_cells;
  slabs = max(slabs, min(2 * sms / n, (span + 7) / 8));
  int slab = (span + slabs - 1) / slabs;
  slab = (slab + 7) / 8 * 8;
  slabs = (span + slab - 1) / slab;
  return launch_kernel(tap_scatter_kernel, dim3(slabs, n), TapSmem::bytes(slab), stream,
                       static_cast<const int*>(base), static_cast<const float4*>(rows),
                       static_cast<float4*>(acc), p, span, slab);
}
