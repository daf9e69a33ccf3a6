// Segmented scatter-add (B17):
//   out = zeros((n_out, W), f32); out[idx[r]] += contrib[r]   for each row r
// Replaces iuvl_tpu/ops/pallas/seg_scatter.py:segmented_scatter_add
// (_seg_kernel). JAX calls it nowhere; it was written for the deformable
// backward's d_value rows (688,128 rows of 256 into 131,072 rows at the
// batch-2 res3 level).
//
// Bound on the card: bytes. Each contrib row is read once (bf16) and each
// output row written once (fp32), with an fp32 add per element: at the
// d_value shape 352 MB in and 134 MB out, ~0.15 ms at 3.35 TB/s.
//
// The TPU kernel sorted the rows by destination, packed them into chunks
// that each fall in one 512-row output window, and summed each chunk as a
// (block, chunk) one-hot matmul on the MXU into the VMEM-resident window,
// zeroing a window on its first chunk. A one-hot product is wasted work on
// the card; what carries over is the sort. The wrapper sorts the rows by
// destination (torch.argsort, as JAX's own argsort runs outside its
// kernel) and finds each destination's segment [starts[d], starts[d + 1])
// of the sorted order. Then each block owns kDest consecutive destination
// rows and, for each, sums its segment's rows in fp32 registers: the
// threads split as (row lane, 8-column group), 256 / (W / 8) row lanes each
// reading every lanes-th row of the segment through the sort's permutation
// in 16-byte pieces; the lanes' sums meet in shared memory and the block writes the
// output row once. No atomics, no zeroing pass: an empty segment writes
// zeros. A destination's rows are summed by one block, so a skewed
// distribution (every row into one destination) serialises on one SM.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kSThreads = 256;
constexpr int kDest = 16;  // destination rows a block

__global__ void __launch_bounds__(kSThreads) seg_scatter_kernel(
    const bf16* __restrict__ contrib, const int* __restrict__ order,
    const int* __restrict__ starts, float* __restrict__ out, int n_out, int width) {
  __shared__ __align__(16) float part[kSThreads * 8];  // lanes x width: 8 values a thread
  const int groups = width / 8, lanes = kSThreads / groups;
  const int lane = threadIdx.x / groups, grp = threadIdx.x % groups;
  const int d0 = blockIdx.x * kDest;
  for (int d = d0; d < min(d0 + kDest, n_out); ++d) {
    float acc[8] = {};
    const int end = starts[d + 1];
#pragma unroll 4
    for (int i = starts[d] + lane; i < end; i += lanes) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          contrib + static_cast<size_t>(order[i]) * width + grp * 8);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += to_f(x[j]);
    }
    float4* mine = reinterpret_cast<float4*>(part + lane * width + grp * 8);
    mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    __syncthreads();
    for (int c = threadIdx.x; c < width; c += kSThreads) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += part[l * width + c];
      out[static_cast<size_t>(d) * width + c] = s;
    }
    __syncthreads();  // part is read before the next destination writes it
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// contrib (R, W) bf16; order (R,) int32, the rows sorted by destination;
// starts (n_out + 1,) int32, destination d's rows order[starts[d] ..
// starts[d + 1]); out (n_out, W) fp32, every row written. W % 8 == 0 and
// W / 8 divides 256.
extern "C" int iuvl_seg_scatter(const void* contrib, const void* order, const void* starts,
                                void* out, int rows, int n_out, int width, void* stream) {
  if (width < 8 || width % 8 || kSThreads % (width / 8) || n_out < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  seg_scatter_kernel<<<(n_out + kDest - 1) / kDest, kSThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(contrib), static_cast<const int*>(order),
      static_cast<const int*>(starts), static_cast<float*>(out), n_out, width);
  return static_cast<int>(cudaGetLastError());
}
