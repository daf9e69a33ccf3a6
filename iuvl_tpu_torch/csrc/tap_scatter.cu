// Tap-row scatter-add of the point-sample backward (B12):
//   acc[n, base[n, p], :] += rows[n, p, :]   (4 fp32 taps per row)
// into a zeroed (N, span, 4) table. Replaces
// iuvl_tpu/ops/pallas/tap_scatter.py:tap_scatter.
//
// Bound on the card: bytes. The work is N*P rows of 16 bytes in and the
// (N, span, 4) fp32 table out (20 x 12544 rows and a 20 x 66,049-row table
// at the criterion's shapes: 4 MB in, 21 MB out), no arithmetic to speak
// of. The TPU kernel kept one map's table in VMEM and walked the rows in a
// serial loop. A map's table (66 k rows x 16 B = 1 MB) does not fit a
// block's shared memory, and sorting 12544 rows by cell to make the sums
// ordered costs more than the scatter itself, so one thread per row adds
// its four taps into the table with fp32 atomicAdd (red.global.add). Rows
// of one map hit ~12.5 k distinct cells out of 66 k, so collisions are
// rare and the atomics run near the memory rate. The summation order of
// colliding rows is not fixed: results differ between runs by fp32
// rounding only, which chip_smoke.py's bound allows for.
#include "common.cuh"

namespace iuvl {
namespace {

__global__ void tap_scatter_kernel(const int* __restrict__ base, const float4* __restrict__ rows,
                                   float* __restrict__ acc, int n, int p, int span) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(n) * p) return;
  const int map = static_cast<int>(i / p);
  const int cell = base[i];
  if (cell < 0 || cell >= span) return;  // the caller clips; guard the table anyway
  const float4 r = rows[i];
  float* dst = acc + (static_cast<size_t>(map) * span + cell) * 4;
  atomicAdd(dst + 0, r.x);
  atomicAdd(dst + 1, r.y);
  atomicAdd(dst + 2, r.z);
  atomicAdd(dst + 3, r.w);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// base: (N, P) int32 in [0, span); rows: (N, P, 4) fp32; acc: (N, span, 4)
// fp32, zeroed by the caller.
extern "C" int iuvl_tap_scatter(const void* base, const void* rows, void* acc, int n, int p,
                                int span, void* stream) {
  const size_t total = static_cast<size_t>(n) * p;
  if (total == 0) return 0;
  const int threads = 256;
  tap_scatter_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(base), static_cast<const float4*>(rows), static_cast<float*>(acc),
      n, p, span);
  return static_cast<int>(cudaGetLastError());
}
