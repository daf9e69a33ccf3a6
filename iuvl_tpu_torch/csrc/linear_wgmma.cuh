// A linear layer on Hopper's warpgroup products: out = epilogue(A B^T)
// with A (M, K) bf16 and B (N, K) bf16 in nn.Linear layout, the sums in
// fp32. It replaces no TPU kernel: it is the projection part of B1
// (window_block.cu: the qkv projection over every window's rows and the
// output projection) and of B2 (flash_attention.cu: the output
// projection), which the TPU kernels computed inside their bodies. An
// epilogue, chosen by a template argument, rounds and stores as its
// caller's TPU kernel does:
// - kEpiRound2: out = bf16(bf16(acc) + bf16(bias)), row-major (M, N) (B1's
//   projection; the JAX math adds the bias in the working dtype);
// - kEpiQkv: the same value, scattered into a (windows, 3, heads, 196, d)
//   layout so that each (window, head)'s q, k and v are contiguous tiles
//   (B1's qkv; M counts 196 rows a window, N = 3 C, aux = C, aux2 = d);
// - kEpiBiasInit: out = bf16(bias + acc), the fp32 accumulator initialised
//   from the bias, as JAX's kernel folds bo in (B2's projection);
// - kEpiGelu: out = bf16(gelu_tanh(bf16(bf16(acc) + bias))), bias bf16
//   (B3's hidden: mlp_block.cu);
// - kEpiResid: out = bf16(bf16(r0 + r1) + bf16(bf16(acc) + bias)), bias
//   bf16, r0 and r1 (M, N) bf16 (B3's output: the block's residual x + a
//   and the MLP's).
// The bias is fp32 for the first three, bf16 for the last two.
// A is row-major, or with kHeadA the head outputs of an attention, (B, H,
// T, d) head-major, read as the (B T, H d) token-major matrix (aux = T,
// aux2 = d): a 16-byte piece of a row never straddles two heads.
//
// Bound on the card: operations (2 M N K; B1's qkv at ViT-B 1024^2 is 17.3
// GFLOP, 0.018 ms at 989 TFLOP/s). The design: a block of two warpgroups
// owns a 128 x 128 tile of out and walks K in 64-deep steps through a
// three-stage cp.async ring in shared memory; each warpgroup issues four
// m64n128k16 wgmma a step on its 64 rows, A and B both read from shared
// memory (a B tile is read from L2 once a block a step). 97 KB a block,
// so two blocks (16 warps) share an SM and one block's barrier and copies
// overlap the other's products. Tiles are stored K-major with the 128-byte
// swizzle: a row's 64 values are one 128-byte line, its 16-byte piece c at
// c ^ (row % 8), 8-row groups 1024 bytes apart; eight lanes copy one row,
// so a warp reads four whole 128-byte lines of device memory and writes
// 512 contiguous bytes of shared memory. (A first build with the
// no-swizzle core-matrix layout of wgmma.cuh, a copy 64 bytes of a row,
// took 0.148 ms of device time at B1's qkv shape: PERF.md, PR 13.) Rows
// past M or N and depth past K load as zero (cp.async zero-fill) and are
// not stored: any M, and N and K multiples of 8.
// Measured (ptxas on the card; no spills): 124 registers (128 with kHeadA),
// 99,328 bytes of shared memory a block. On the card (H100 SXM, 700 W;
// tools/kernel_ab.py, PERF.md) B1's qkv at ViT-B 1024^2 (4900 x 2304 x 768)
// takes 0.0555 ms (312 TFLOP/s), its projection 0.020, B2's 0.023, B3's
// hidden and output at ViT-B 1024^2 0.058 and 0.054; keeping
// one wgmma group in flight across the step's barrier moved nothing
// (tools/gemm_variants.py), and 256 x 128 tiles (four warpgroups, four
// stages, one block an SM) were slower at every B3 shape (0.137 against
// 0.122 ms at ViT-B 1024^2; PERF.md §6).
#pragma once

#include "wgmma.cuh"

namespace iuvl {
namespace {

enum LinearEpi { kEpiRound2 = 0, kEpiQkv = 1, kEpiBiasInit = 2, kEpiGelu = 3, kEpiResid = 4 };

constexpr int kLinBM = 128, kLinBN = 128, kLinBK = 64, kLinStages = 3;
constexpr int kLinThreads = 256;           // two warpgroups, 64 rows each
constexpr int kLinTile = kLinBM * kLinBK;  // bf16 elements of an A (or B) tile
// The stages, and 1 KB to align them to the swizzle's 1024-byte period.
constexpr size_t kLinSmem = static_cast<size_t>(kLinStages) * 2 * kLinTile * sizeof(bf16) + 1024;

// The descriptor of a K-major tile with the 128-byte swizzle at p (1024-byte
// aligned; step s of 16 values is + 2 s): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// out = epilogue(A B^T); grid (ceil(N / 128), ceil(M / 128)).
template <int kEpi, bool kHeadA>
__global__ void __launch_bounds__(kLinThreads, 2) linear_wgmma_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b, const void* __restrict__ bias_,
    bf16* __restrict__ out, int M, int N, int K, int aux, int aux2, const bf16* __restrict__ r0,
    const bf16* __restrict__ r1) {
  constexpr bool kBf16Bias = kEpi == kEpiGelu || kEpi == kEpiResid;
  const float* bias = static_cast<const float*>(bias_);  // the fp32 bias, or:
  const bf16* bias16 = static_cast<const bf16*>(bias_);  // the bf16 one
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  bf16* sB = sA + kLinStages * kLinTile;  // kLinStages A tiles, then kLinStages B tiles
  const int m0 = blockIdx.y * kLinBM, n0 = blockIdx.x * kLinBN;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int steps = (K + kLinBK - 1) / kLinBK;
  // This thread copies rows rr + 32 j (j < 4) of each tile, its piece c.
  const int rr = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int dst = rr * kLinBK + ((c ^ (rr & 7)) * 8);
  auto issue = [&](int kt) {
    const int st = kt % kLinStages, k = kt * kLinBK + c * 8;
    const bool kin = k < K;
    size_t koff = k;  // A's column k: row-major, or head k / d of a head-major A
    if constexpr (kHeadA) koff = static_cast<size_t>(k / aux2) * aux * aux2 + k % aux2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = m0 + rr + 32 * j, rb = n0 + rr + 32 * j;
      size_t aoff = static_cast<size_t>(ra) * K;
      if constexpr (kHeadA) {  // token ra = (batch, t): (batch H T + t) d
        const int bt = ra / aux;
        aoff = (static_cast<size_t>(bt) * (K / aux2) * aux + (ra - bt * aux)) * aux2;
      }
      const bool ina = kin && ra < M, inb = kin && rb < N;
      cp_async16_zfill(sA + st * kLinTile + dst + 32 * kLinBK * j, a + (ina ? aoff + koff : 0),
                       ina);
      cp_async16_zfill(sB + st * kLinTile + dst + 32 * kLinBK * j,
                       b + (inb ? static_cast<size_t>(rb) * K + k : 0), inb);
    }
  };
#pragma unroll
  for (int s = 0; s < kLinStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  // Lane's columns of 8-column tile j: n0 + 8 j + c2, + 1; rows m0 + 64 wg
  // + 16 warp + lane / 4, + 8 (wgmma.cuh).
  const int c2 = 2 * (lane & 3), row = m0 + 64 * wg + 16 * warp + (lane >> 2);
  float acc[64];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + c2;
    const float b0 = kEpi == kEpiBiasInit && col < N ? bias[col] : 0.f;
    const float b1 = kEpi == kEpiBiasInit && col < N ? bias[col + 1] : 0.f;
    acc[4 * j] = acc[4 * j + 2] = b0;
    acc[4 * j + 1] = acc[4 * j + 3] = b1;
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kLinStages - 2>();
    fence_async_smem();
    __syncthreads();  // step kt landed; every warpgroup's products of step kt - 1 are done
    if (kt + kLinStages - 1 < steps) issue(kt + kLinStages - 1);  // into step kt - 1's slot
    cp_async_commit();
    const int st = kt % kLinStages;
    const uint64_t da = sw128_desc(sA + st * kLinTile + 64 * kLinBK * wg);
    const uint64_t db = sw128_desc(sB + st * kLinTile);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kLinBK / 16; ++s) wgmma_ss_n128(acc, da + 2 * s, db + 2 * s, 1);
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
  }

  // Epilogue: column pairs (col, col + 1) of rows row, row + 8.
  size_t roff[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = row + 8 * u;
    if constexpr (kEpi == kEpiQkv) {  // window r / 196, token r % 196
      const int win = r / 196, i = r - win * 196;
      roff[u] = static_cast<size_t>(win) * 3 * aux * 196 + static_cast<size_t>(i) * aux2;
    } else {
      roff[u] = static_cast<size_t>(r) * N;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + c2;
    if (col >= N) continue;
    size_t coff = col;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (kBf16Bias) {
      b0 = to_f(bias16[col]);
      b1 = to_f(bias16[col + 1]);
    } else if constexpr (kEpi != kEpiBiasInit) {
      b0 = round_bf(bias[col]);
      b1 = round_bf(bias[col + 1]);
    }
    if constexpr (kEpi == kEpiQkv) {  // (which, head, column) of q | k | v
      const int which = col / aux, hc = col - which * aux, head = hc / aux2;
      coff = static_cast<size_t>(which * (aux / aux2) + head) * 196 * aux2 + (hc - head * aux2);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (row + 8 * u >= M) continue;
      const float x0 = acc[4 * j + 2 * u], x1 = acc[4 * j + 2 * u + 1];
      uint32_t v;
      if constexpr (kEpi == kEpiBiasInit) {
        v = pack_bf16(x0, x1);
      } else if constexpr (kEpi == kEpiGelu) {  // GELU on the bf16 value, rounded
        v = pack_bf16(gelu_tanh(round_bf(round_bf(x0) + b0)),
                      gelu_tanh(round_bf(round_bf(x1) + b1)));
      } else if constexpr (kEpi == kEpiResid) {  // bf16(x + a) + bf16(bf16(acc) + bias)
        const size_t at = roff[u] + coff;
        const __nv_bfloat162 res = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(r0 + at),
                                           *reinterpret_cast<const __nv_bfloat162*>(r1 + at));
        const float2 rf = __bfloat1622float2(res);
        v = pack_bf16(rf.x + round_bf(round_bf(x0) + b0), rf.y + round_bf(round_bf(x1) + b1));
      } else {
        v = pack_bf16(round_bf(x0) + b0, round_bf(x1) + b1);
      }
      *reinterpret_cast<uint32_t*>(out + roff[u] + coff) = v;
    }
  }
}

// Launch out = epilogue(a b^T) on stream s; returns cudaGetLastError().
template <int kEpi, bool kHeadA = false>
int linear_wgmma(const bf16* a, const bf16* b, const void* bias, bf16* out, int M, int N, int K,
                 int aux, int aux2, cudaStream_t s, const bf16* r0 = nullptr,
                 const bf16* r1 = nullptr) {
  if (M < 1 || N < 8 || K < 8 || N % 8 || K % 8 || (kHeadA && (aux < 1 || K % aux2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = cudaFuncSetAttribute(linear_wgmma_kernel<kEpi, kHeadA>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kLinSmem)))
    return static_cast<int>(err);
  const dim3 grid((N + kLinBN - 1) / kLinBN, (M + kLinBM - 1) / kLinBM);
  linear_wgmma_kernel<kEpi, kHeadA><<<grid, kLinThreads, kLinSmem, s>>>(a, b, bias, out, M, N,
                                                                        K, aux, aux2, r0, r1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl
