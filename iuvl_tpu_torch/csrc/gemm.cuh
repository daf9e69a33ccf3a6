// Tiled bf16 GEMM with fp32 output and the small reductions that the
// backward kernels (B9 window_block_bwd.cu, B10 mlp_block_bwd.cu) share.
//
// C (M x N, fp32, row-major) = op(A) op(B)^T over a depth K, where
//   A_T == false: A is (M, K) row-major;  A_T == true: A is stored (K, M);
//   B_T == false: B is (N, K) row-major (nn.Linear's weight layout);
//   B_T == true:  B is stored (K, N).
// So the forward recompute (x @ W^T), the input gradient (dy @ W) and the
// weight gradient (dY^T X, a sum over all token rows) are one kernel.
// Each block owns a 64 x 128 tile of C and walks the whole depth, so a
// weight gradient is summed over every row inside one block: no partials,
// no atomics, the same order on every run. Tiles of A and B are staged in
// shared memory (zero-filled past M, N and K) with 16-byte loads; the
// contiguous dimension of each operand must be a multiple of 8. Eight
// warps each hold a 32 x 32 tile of fp32 accumulators. A first, simple
// version: no cp.async pipeline and no wgmma.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace iuvl {
// Internal linkage: every kernel source that includes this gets its own copy.
namespace {

constexpr int kGM = 64, kGN = 128, kGK = 32;

template <bool A_T, bool B_T>
struct GemmSmem {
  static constexpr int kLdA = A_T ? kGM + 8 : kGK + 8;
  static constexpr int kLdB = B_T ? kGN + 8 : kGK + 8;
  static constexpr int kA = A_T ? kGK * kLdA : kGM * kLdA;
  static constexpr int kB = B_T ? kGK * kLdB : kGN * kLdB;
};

template <bool A_T, bool B_T>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ C,
    int M, int N, int K) {
  using L = GemmSmem<A_T, B_T>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                std::conditional_t<A_T, wmma::col_major, wmma::row_major>>;
  __shared__ __align__(128) bf16 As[L::kA];
  __shared__ __align__(128) bf16 Bs[L::kB];
  __shared__ __align__(128) float stage_all[kWarps * 256];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kGK) {
    __syncthreads();  // the previous tiles are consumed
    if (!A_T) {       // 64 rows x 4 vectors
      const int r = tid >> 2, v = (tid & 3) * 8;
      const bool in = m0 + r < M && k0 + v < K;
      *reinterpret_cast<uint4*>(As + r * L::kLdA + v) =
          in ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * K + k0 + v) : zero;
    } else {  // 32 rows (k) x 8 vectors (m)
      const int r = tid >> 3, v = (tid & 7) * 8;
      const bool in = k0 + r < K && m0 + v < M;
      *reinterpret_cast<uint4*>(As + r * L::kLdA + v) =
          in ? *reinterpret_cast<const uint4*>(A + static_cast<size_t>(k0 + r) * M + m0 + v) : zero;
    }
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int i = tid + part * kThreads;
      if (!B_T) {  // 128 rows (n) x 4 vectors (k)
        const int r = i >> 2, v = (i & 3) * 8;
        const bool in = n0 + r < N && k0 + v < K;
        *reinterpret_cast<uint4*>(Bs + r * L::kLdB + v) =
            in ? *reinterpret_cast<const uint4*>(B + static_cast<size_t>(n0 + r) * K + k0 + v) : zero;
      } else {  // 32 rows (k) x 16 vectors (n)
        const int r = i >> 4, v = (i & 15) * 8;
        const bool in = k0 + r < K && n0 + v < N;
        *reinterpret_cast<uint4*>(Bs + r * L::kLdB + v) =
            in ? *reinterpret_cast<const uint4*>(B + static_cast<size_t>(k0 + r) * N + n0 + v) : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      FragAT fa[2];  // A[m][k] = As[m][k], or As[k][m] when A_T
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A_T ? As + kk * L::kLdA + wm + i * 16
                                          : As + (wm + i * 16) * L::kLdA + kk, L::kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!B_T) {
          FragBc fb;  // B[k][n] = Bs[n][k]
          wmma::load_matrix_sync(fb, Bs + (wn + j * 16) * L::kLdB + kk, L::kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          FragBr fb;  // B[k][n] = Bs[k][n]
          wmma::load_matrix_sync(fb, Bs + kk * L::kLdB + wn + j * 16, L::kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
  }
  float* st = stage_all + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = m0 + wm + i * 16 + e / 16, c = n0 + wn + j * 16 + e % 16;
        if (r < M && c < N) C[static_cast<size_t>(r) * N + c] = st[e];
      }
      __syncwarp();
    }
  }
}

// Launch gemm_f32_kernel; returns cudaGetLastError().
template <bool A_T, bool B_T>
int gemm_f32(const bf16* A, const bf16* B, float* C, int M, int N, int K, cudaStream_t stream) {
  if ((A_T ? M : K) % 8 || (B_T ? N : K) % 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM);
  gemm_f32_kernel<A_T, B_T><<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// out[c] = sum_r a[r, c] in fp32 (a bias gradient): 32 columns a block,
// 8 row lanes per column summed in shared memory, in a fixed order.
__device__ __forceinline__ float as_f(bf16 x) { return to_f(x); }
__device__ __forceinline__ float as_f(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(kThreads) colsum_kernel(const T* __restrict__ a,
                                                           float* __restrict__ out, int rows,
                                                           int cols) {
  __shared__ float part[8][33];
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (c < cols)
    for (int r = ry; r < rows; r += 8) s += as_f(a[static_cast<size_t>(r) * cols + c]);
  part[ry][cx] = s;
  __syncthreads();
  if (ry == 0 && c < cols) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][cx];
    out[c] = t;
  }
}

template <typename T>
int colsum(const T* a, float* out, int rows, int cols, cudaStream_t stream) {
  colsum_kernel<T><<<(cols + 31) / 32, kThreads, 0, stream>>>(a, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum_p part[p * n + i] over `parts` fp32 partials, in order.
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

inline int sum_parts(const float* part, float* out, int parts, int n, cudaStream_t stream) {
  sum_parts_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, out, parts, n);
  return static_cast<int>(cudaGetLastError());
}

// out[r, c] = bf16(round_bf(in[r, c]) + round_bf(bias[c])), or bf16(in) with
// no bias: a bf16 product's rounding, then a bias added in bf16 (flax
// Dense(dtype=bf16) and the plain versions' ``x @ w.t() + b``).
__global__ void round_bias_kernel(const float* __restrict__ in, const float* __restrict__ bias,
                                  bf16* __restrict__ out, size_t total, int cols) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = bias ? to_bf(round_bf(in[i]) + round_bf(bias[i % cols])) : to_bf(in[i]);
}

inline int round_bias(const float* in, const float* bias, bf16* out, size_t rows, int cols,
                      cudaStream_t stream) {
  const size_t total = rows * cols;
  round_bias_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      in, bias, out, total, cols);
  return static_cast<int>(cudaGetLastError());
}

// Chain launches: stop at the first error.
#define IUVL_TRY(call)              \
  do {                              \
    const int err_ = (call);        \
    if (err_ != 0) return err_;     \
  } while (0)

}  // namespace
}  // namespace iuvl
