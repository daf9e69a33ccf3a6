// A bf16 GEMM on Hopper's warpgroup products: out = epilogue(A B^T) over a
// depth K with fp32 sums. It replaces no TPU kernel of its own: it is the
// projection part of B1 (window_block.cu: the qkv projection over every
// window's rows and the output projection), of B2 (flash_attention.cu: the
// output projection) and of B3 (mlp_block.cu: the MLP), which the TPU
// kernels computed inside their bodies, and every product of the backward
// kernels B9 (window_block_bwd.cu) and B10 (mlp_block_bwd.cu).
//
// Operands, by template argument:
// - A (M, K): kRowK row-major (M, K); kHeadK the head outputs of an
//   attention, (B, H, T, d) head-major, read as the (B T, H d) token-major
//   matrix (aux = T, aux2 = d: a 16-byte piece of a row never straddles two
//   heads); kMn stored (K, M) row-major with pitch lda, M-major (a weight
//   gradient's dY^T: the token rows are the depth).
// - B (N, K): kRowK row-major (N, K), nn.Linear's weight layout (x W^T);
//   kMn stored (K, N) row-major with pitch ldb, N-major (dy W, or the token
//   rows of a weight gradient).
// An epilogue, chosen by a template argument, rounds and stores as its
// caller's TPU kernel does:
// - kEpiRound2: out = bf16(bf16(acc) + bf16(bias)), row-major (M, N) (B1's
//   projection; the JAX math adds the bias in the working dtype);
// - kEpiQkv: the same value, scattered into a (windows, 3, heads, 196, d)
//   layout so that each (window, head)'s q, k and v are contiguous tiles
//   (B1's and B9's qkv; M counts 196 rows a window, N = 3 C, aux = C, aux2
//   = d);
// - kEpiBiasInit: out = bf16(bias + acc), the fp32 accumulator initialised
//   from the bias, as JAX's kernel folds bo in (B2's projection);
// - kEpiGelu: out = bf16(gelu_tanh(bf16(bf16(acc) + bias))), bias bf16
//   (B3's hidden);
// - kEpiResid: out = bf16(bf16(r0 + r1) + bf16(bf16(acc) + bias)), bias
//   bf16, r0 and r1 (M, N) bf16 (B3's output: the block's residual x + a
//   and the MLP's);
// - kEpiHidden: out = bf16(bf16(acc) + bias), bias bf16 (B10's recomputed
//   hidden before the GELU, hpre);
// - kEpiGeluBwd: from hp = r0 (M, N) bf16 (hpre), out = bf16(gelu_tanh(hp))
//   and out2 = bf16(acc gelu_tanh'(hp)) (B10's h and dhpre; acc is dh), the
//   tiles staged through shared memory so that hpre, h and dhpre move in
//   whole 16-byte pieces (gelu_bwd_store);
// - kEpiBf16: out = bf16(acc), row-major (B9's dx);
// - kEpiHeads: bf16(acc) in kEpiQkv's layout with N = C, (windows, heads,
//   196, d) (B9's do);
// - kEpiF32: out = acc, fp32 row-major. With splits > 1 (B9's and B10's
//   weight gradients, whose depth is every token row) the blocks of an
//   output tile are one thread block cluster along grid.z: block z sums the
//   depth's 64-deep steps [z S, z S + S) (S = split_steps), puts its fp32
//   tile in its own shared memory, and after a cluster barrier adds rows
//   [z 128 / splits, (z + 1) 128 / splits) of all the cluster's tiles in
//   split order, read through distributed shared memory, and stores them:
//   no partials in device memory, no atomics, the same bits on every run.
//
// Bound on the card: operations (2 M N K; B1's qkv at ViT-B 1024^2 is 17.3
// GFLOP, 0.018 ms at 989 TFLOP/s). The design: a block of two warpgroups
// owns a 128 x 128 tile of out and walks K in 64-deep steps through a
// three-stage cp.async ring in shared memory; each warpgroup issues four
// m64n128k16 wgmma a step on its 64 rows, A and B both read from shared
// memory (a B tile is read from L2 once a block a step). 97 KB a block,
// so two blocks (16 warps) share an SM and one block's barrier and copies
// overlap the other's products. Tiles are stored with the 128-byte swizzle:
// - K-major (kRowK, kHeadK): a row's 64 depth values are one 128-byte line,
//   its 16-byte piece c at c ^ (row % 8), 8-row groups 1024 bytes apart
//   (the descriptor's SBO; LBO unused); eight lanes copy one row, so a warp
//   reads four whole 128-byte lines and writes 512 contiguous bytes of
//   shared memory;
// - MN-major (kMn): the tile is two 64-wide halves of M (N); a half keeps
//   each of the 64 depth values' 64 M (N) values as one 128-byte line, piece
//   c at c ^ (k % 8); 8-line groups of the depth are 1024 bytes apart (SBO),
//   the two halves 8192 bytes (LBO: the roles of the two offsets swap), and
//   the wgmma's transpose bit says so. Sixteen lanes copy one stored row's
//   256 bytes.
// A 16-deep step is 32 bytes on in a K-major tile, 2048 in an MN-major one.
// (A first build with the no-swizzle core-matrix layout of wgmma.cuh, a
// copy 64 bytes of a row, took 0.148 ms of device time at B1's qkv shape:
// PERF.md §6.) Rows past M or N and depth past K load as zero
// (cp.async zero-fill) and are not stored: any M, N, lda and ldb multiples
// of 8, M too with an MN-major A, and K too unless both are MN-major.
// Measured (ptxas on the card): 121-128 registers (110 with both operands
// MN-major; kEpiGeluBwd spills 8 bytes), 99,328 bytes of shared memory a
// block. On the card (H100 SXM, 700 W; tools/kernel_ab.py, PERF.md) B1's
// qkv at ViT-B 1024^2 (4900 x 2304 x 768) takes 0.0555 ms (312 TFLOP/s),
// its projection 0.020, B2's 0.023, B3's hidden and output at ViT-B
// 1024^2 0.058 and 0.054; B10's dy (B MN-major) 0.052 and dW1 (3072 x 768
// over 4096 rows, both MN-major, two splits) 0.061 (cuBLAS through
// torch.matmul: 0.031 and 0.030); keeping
// one wgmma group in flight across the step's barrier moved nothing
// (tools/gemm_variants.py), and 256 x 128 tiles (four warpgroups, four
// stages, one block an SM) were slower at every B3 shape (0.137 against
// 0.122 ms at ViT-B 1024^2; PERF.md §6).
#pragma once

#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace iuvl {
namespace {

enum LinearEpi {
  kEpiRound2 = 0, kEpiQkv = 1, kEpiBiasInit = 2, kEpiGelu = 3, kEpiResid = 4, kEpiHidden = 5,
  kEpiGeluBwd = 6, kEpiBf16 = 7, kEpiHeads = 8, kEpiF32 = 9
};
enum LinearLayout { kRowK = 0, kHeadK = 1, kMn = 2 };

constexpr int kLinBM = 128, kLinBN = 128, kLinBK = 64, kLinStages = 3;
constexpr int kLinThreads = 256;           // two warpgroups, 64 rows each
constexpr int kLinTile = kLinBM * kLinBK;  // bf16 elements of an A (or B) tile
// The stages, and 1 KB to align them to the swizzle's 1024-byte period.
constexpr size_t kLinSmem = static_cast<size_t>(kLinStages) * 2 * kLinTile * sizeof(bf16) + 1024;
// An MN-major tile's descriptor offsets (bytes): the two 64-wide halves
// (LBO) and the 8-line groups of the depth (SBO).
constexpr uint64_t kMnLbo = 8192, kMnSbo = 1024;

// The tanh-GELU (common.cuh gelu_tanh) and its derivative (iuvl_tpu
// mlp_block._gelu_grad_f32) at x, from one tanh.
__device__ __forceinline__ float2 gelu_tanh_and_grad(float x) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (x + a * x * x * x));
  return make_float2(0.5f * x * (1.f + t),
                     0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * a * x * x));
}

// The descriptor of a K-major tile with the 128-byte swizzle at p (1024-byte
// aligned; step s of 16 values is + 2 s): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// The descriptor of an MN-major tile with the 128-byte swizzle at p (step s
// of 16 values is + 128 s).
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         ((kMnLbo >> 4) << 16) | ((kMnSbo >> 4) << 32) |
         (uint64_t{1} << 62);
}

struct LinearParams {
  const bf16* a;
  const bf16* b;
  const void* bias;  // fp32, or bf16 for kEpiGelu, kEpiResid, kEpiHidden
  void* out;         // bf16, or fp32 for kEpiF32
  int M, N, K;
  int lda, ldb;      // the stored pitch of an MN-major A (B)
  int aux, aux2;     // kHeadK: tokens a batch, head dim; kEpiQkv / kEpiHeads: C, head dim
  const bf16* r0;    // kEpiResid: x, kEpiGeluBwd: hpre
  const bf16* r1;    // kEpiResid: a
  bf16* out2;        // kEpiGeluBwd: dhpre
  int split_steps;   // 64-deep steps a split (grid.z splits; kEpiF32)
};

// Copy rows [r0, r0 + 128) x depth [k, k + 64) of a K-major operand into the
// swizzled tile t: rows of pitch K (kRowK) or the head-major rows of kHeadK.
template <int kLay>
__device__ __forceinline__ void load_k_major(bf16* t, const bf16* src, int r0, int rows, int k,
                                             int K, int aux, int aux2) {
  const int rr = threadIdx.x >> 3, c = threadIdx.x & 7;  // rows rr + 32 j, piece c
  const int dst = rr * kLinBK + ((c ^ (rr & 7)) * 8);
  const int kc = k + c * 8;
  const bool kin = kc < K;
  size_t koff = kc;  // column kc: row-major, or head kc / d of a head-major A
  if constexpr (kLay == kHeadK) koff = static_cast<size_t>(kc / aux2) * aux * aux2 + kc % aux2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + rr + 32 * j;
    size_t roff = static_cast<size_t>(r) * K;
    if constexpr (kLay == kHeadK) {  // token r = (batch, t): (batch H T + t) d
      const int bt = r / aux;
      roff = (static_cast<size_t>(bt) * (K / aux2) * aux + (r - bt * aux)) * aux2;
    }
    const bool in = kin && r < rows;
    cp_async16_zfill(t + dst + 32 * kLinBK * j, src + (in ? roff + koff : 0), in);
  }
}

// Copy depth [k, k + 64) x columns [m0, m0 + 128) of an MN-major operand
// (stored (K, M) with pitch ld) into the swizzled tile t: half h = column /
// 64 at t + 4096 h, depth line kk of a half at kk * 64, piece p at p ^ (kk %
// 8).
__device__ __forceinline__ void load_mn_major(bf16* t, const bf16* src, int m0, int cols, int k,
                                              int K, int ld) {
  const int kr = threadIdx.x >> 4, c = threadIdx.x & 15;  // lines kr + 16 j, piece c
  const int half = c >> 3, p = c & 7, col = m0 + 8 * c;
  const bool cin = col < cols;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = kr + 16 * j;
    const bool in = cin && k + kk < K;
    cp_async16_zfill(t + half * 64 * kLinBK + kk * 64 + ((p ^ (kk & 7)) * 8),
                     src + (in ? static_cast<size_t>(k + kk) * ld + col : 0), in);
  }
}

constexpr int kRedLd = kLinBN + 8;  // fp32 pitch of a split's tile in shared memory

// The split-K epilogue: this block's tile into red (shared memory, free
// once every warpgroup's last products are done), a cluster barrier, then
// rows [z R, z R + R) (R = 128 / splits) of the cluster's tiles summed in
// split order into out, and a barrier so that no tile is left while read.
__device__ __forceinline__ void splitk_cluster_store(const float (&acc)[64], float* red,
                                                     float* out, int m0, int n0, int M, int N) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int lr = 64 * wg + 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      *reinterpret_cast<float2*>(red + (lr + 8 * u) * kRedLd + 8 * j + c2) =
          make_float2(acc[4 * j + 2 * u], acc[4 * j + 2 * u + 1]);
  cluster.sync();
  const int splits = static_cast<int>(cluster.num_blocks()), z = cluster.block_rank();
  const int rows = kLinBM / splits;
  for (int i = threadIdx.x; i < rows * (kLinBN / 4); i += kLinThreads) {
    const int r = z * rows + i / (kLinBN / 4), c = 4 * (i % (kLinBN / 4));
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) + r * kRedLd + c);
    for (int q = 1; q < splits; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + r * kRedLd + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * N + n0 + c) = s;
  }
  cluster.sync();
}

constexpr int kStageLd = kLinBN + 8;  // bf16 pitch of a tile staged in shared memory

// kEpiGeluBwd's epilogue through shared memory (st, free once every
// warpgroup's last products are done): the hpre tile in with 16-byte
// loads, h over it and dhpre beside it from the accumulator (the rows of
// the lane quads land in distinct banks), then both out with 16-byte
// stores, sixteen lanes a row.
__device__ __forceinline__ void gelu_bwd_store(const float (&acc)[64], bf16* st,
                                               const LinearParams& p, int m0, int n0) {
  bf16* sh = st;                      // hpre, then h
  bf16* sd = st + kLinBM * kStageLd;  // dhpre
  const int pc = threadIdx.x & 15, r0 = threadIdx.x >> 4;  // piece pc of rows r0 + 16 i
  const int col = n0 + 8 * pc;
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLinBM / 16; ++i) {
    const int r = r0 + 16 * i;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < p.M && col < p.N)
      v = *reinterpret_cast<const uint4*>(p.r0 + static_cast<size_t>(m0 + r) * p.N + col);
    *reinterpret_cast<uint4*>(sh + r * kStageLd + 8 * pc) = v;
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int lr = 64 * wg + 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int at = (lr + 8 * u) * kStageLd + 8 * j + c2;
      const float2 hp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sh + at));
      const float2 g0 = gelu_tanh_and_grad(hp.x), g1 = gelu_tanh_and_grad(hp.y);
      *reinterpret_cast<uint32_t*>(sh + at) = pack_bf16(g0.x, g1.x);
      *reinterpret_cast<uint32_t*>(sd + at) =
          pack_bf16(acc[4 * j + 2 * u] * g0.y, acc[4 * j + 2 * u + 1] * g1.y);
    }
  __syncthreads();
  bf16* h = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < kLinBM / 16; ++i) {
    const int r = r0 + 16 * i;
    if (m0 + r >= p.M || col >= p.N) continue;
    const size_t at = static_cast<size_t>(m0 + r) * p.N + col;
    *reinterpret_cast<uint4*>(h + at) = *reinterpret_cast<const uint4*>(sh + r * kStageLd + 8 * pc);
    *reinterpret_cast<uint4*>(p.out2 + at) =
        *reinterpret_cast<const uint4*>(sd + r * kStageLd + 8 * pc);
  }
}

// out = epilogue(A B^T); grid (ceil(N / 128), ceil(M / 128), splits), with
// clusters of (1, 1, splits) blocks when splits > 1.
template <int kEpi, int kLayA, int kLayB>
__global__ void __launch_bounds__(kLinThreads, 2) linear_wgmma_kernel(const LinearParams p) {
  constexpr bool kBf16Bias = kEpi == kEpiGelu || kEpi == kEpiResid || kEpi == kEpiHidden;
  constexpr bool kHeads = kEpi == kEpiQkv || kEpi == kEpiHeads;
  const int M = p.M, N = p.N, K = p.K;
  const float* bias = static_cast<const float*>(p.bias);  // the fp32 bias, or:
  const bf16* bias16 = static_cast<const bf16*>(p.bias);  // the bf16 one
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  bf16* sB = sA + kLinStages * kLinTile;  // kLinStages A tiles, then kLinStages B tiles
  const int m0 = blockIdx.y * kLinBM, n0 = blockIdx.x * kLinBN;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int all_steps = (K + kLinBK - 1) / kLinBK;
  const int kt0 = kEpi == kEpiF32 ? blockIdx.z * p.split_steps : 0;
  const int steps = kEpi == kEpiF32 ? min(p.split_steps, all_steps - kt0) : all_steps;
  auto issue = [&](int i) {
    const int st = i % kLinStages, k = (kt0 + i) * kLinBK;
    if constexpr (kLayA == kMn)
      load_mn_major(sA + st * kLinTile, p.a, m0, M, k, K, p.lda);
    else
      load_k_major<kLayA>(sA + st * kLinTile, p.a, m0, M, k, K, p.aux, p.aux2);
    if constexpr (kLayB == kMn)
      load_mn_major(sB + st * kLinTile, p.b, n0, N, k, K, p.ldb);
    else
      load_k_major<kRowK>(sB + st * kLinTile, p.b, n0, N, k, K, 0, 0);
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
  constexpr int kStepA = kLayA == kMn ? 2048 >> 4 : 2, kStepB = kLayB == kMn ? 2048 >> 4 : 2;
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kLinStages - 2>();
    fence_async_smem();
    __syncthreads();  // step kt landed; every warpgroup's products of step kt - 1 are done
    if (kt + kLinStages - 1 < steps) issue(kt + kLinStages - 1);  // into step kt - 1's slot
    cp_async_commit();
    const int st = kt % kLinStages;
    const bf16* ta = sA + st * kLinTile + 64 * kLinBK * wg;  // the warpgroup's 64 rows
    const bf16* tb = sB + st * kLinTile;
    const uint64_t da = kLayA == kMn ? sw128_mn_desc(ta) : sw128_desc(ta);
    const uint64_t db = kLayB == kMn ? sw128_mn_desc(tb) : sw128_desc(tb);
    wg_fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kLinBK / 16; ++s)
      wgmma_ss_n128t<kLayA == kMn, kLayB == kMn>(acc, da + kStepA * s, db + kStepB * s, 1);
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
  }

  // Epilogue: column pairs (col, col + 1) of rows row, row + 8.
  size_t roff[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = row + 8 * u;
    if constexpr (kHeads) {  // window r / 196, token r % 196
      const int win = r / 196, i = r - win * 196;
      roff[u] = static_cast<size_t>(win) * N * 196 + static_cast<size_t>(i) * p.aux2;
    } else {
      roff[u] = static_cast<size_t>(r) * N;
    }
  }
  float* out32 = static_cast<float*>(p.out);
  if constexpr (kEpi == kEpiF32) {
    if (gridDim.z > 1) {  // split-K: the cluster's fixed-order sum (see the header)
      splitk_cluster_store(acc, reinterpret_cast<float*>(sA), out32, m0, n0, M, N);
      return;
    }
  }
  if constexpr (kEpi == kEpiGeluBwd) {  // h and dhpre, staged through shared memory
    gelu_bwd_store(acc, sA, p, m0, n0);
    return;
  }
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + c2;
    if (col >= N) continue;
    size_t coff = col;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (kBf16Bias) {
      b0 = to_f(bias16[col]);
      b1 = to_f(bias16[col + 1]);
    } else if constexpr (kEpi == kEpiRound2 || kEpi == kEpiQkv) {
      b0 = round_bf(bias[col]);
      b1 = round_bf(bias[col + 1]);
    }
    if constexpr (kHeads) {  // (which, head, column) of q | k | v
      const int which = col / p.aux, hc = col - which * p.aux, head = hc / p.aux2;
      coff = static_cast<size_t>(which * (p.aux / p.aux2) + head) * 196 * p.aux2 +
             (hc - head * p.aux2);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (row + 8 * u >= M) continue;
      const float x0 = acc[4 * j + 2 * u], x1 = acc[4 * j + 2 * u + 1];
      const size_t at = roff[u] + coff;
      if constexpr (kEpi == kEpiF32) {
        *reinterpret_cast<float2*>(out32 + at) = make_float2(x0, x1);
        continue;
      }
      uint32_t v;
      if constexpr (kEpi == kEpiBiasInit || kEpi == kEpiBf16 || kEpi == kEpiHeads) {
        v = pack_bf16(x0, x1);
      } else if constexpr (kEpi == kEpiGelu) {  // GELU on the bf16 value, rounded
        v = pack_bf16(gelu_tanh(round_bf(round_bf(x0) + b0)),
                      gelu_tanh(round_bf(round_bf(x1) + b1)));
      } else if constexpr (kEpi == kEpiResid) {  // bf16(x + a) + bf16(bf16(acc) + bias)
        const __nv_bfloat162 res = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(p.r0 + at),
                                           *reinterpret_cast<const __nv_bfloat162*>(p.r1 + at));
        const float2 rf = __bfloat1622float2(res);
        v = pack_bf16(rf.x + round_bf(round_bf(x0) + b0), rf.y + round_bf(round_bf(x1) + b1));
      } else {  // kEpiRound2, kEpiQkv, kEpiHidden
        v = pack_bf16(round_bf(x0) + b0, round_bf(x1) + b1);
      }
      *reinterpret_cast<uint32_t*>(out + at) = v;
    }
  }
}

// The 64-deep steps a split of depth K into `splits` (the last split takes
// what is left; Python's split_k gives the same).
inline int split_steps(int K, int splits) {
  const int steps = (K + kLinBK - 1) / kLinBK;
  return (steps + splits - 1) / splits;
}

// Launch out = epilogue(A B^T) on stream s; splits (1, 2, 4 or 8; kEpiF32
// only) blocks of a cluster share an output tile's depth. Returns
// cudaGetLastError().
template <int kEpi, int kLayA = kRowK, int kLayB = kRowK>
int linear_gemm(LinearParams p, cudaStream_t s, int splits = 1) {
  const bool bad_a = kLayA == kHeadK ? p.aux < 1 || p.K % p.aux2
                                     : kLayA == kMn && (p.M % 8 || p.lda % 8 || p.lda < p.M);
  const bool bad_b = kLayB == kMn && (p.ldb % 8 || p.ldb < p.N);
  const bool bad_split = (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
                         (splits > 1 && kEpi != kEpiF32);
  const bool bad_k = (kLayA != kMn || kLayB != kMn) && p.K % 8;  // K-major pieces along K
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || bad_k || bad_a || bad_b || bad_split)
    return static_cast<int>(cudaErrorInvalidValue);
  p.split_steps = split_steps(p.K, splits);
  if ((splits - 1) * p.split_steps * kLinBK >= p.K) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = linear_wgmma_kernel<kEpi, kLayA, kLayB>;
  if (cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kLinSmem)))
    return static_cast<int>(err);
  const dim3 grid((p.N + kLinBN - 1) / kLinBN, (p.M + kLinBM - 1) / kLinBM, splits);
  if (splits == 1) {
    kernel<<<grid, kLinThreads, kLinSmem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kLinThreads);
  cfg.dynamicSmemBytes = kLinSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p)) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The K-major GEMM of B1-B3: out = epilogue(a b^T), a (M, K) row-major (or
// head-major with kHeadA), b (N, K).
template <int kEpi, bool kHeadA = false>
int linear_wgmma(const bf16* a, const bf16* b, const void* bias, bf16* out, int M, int N, int K,
                 int aux, int aux2, cudaStream_t s, const bf16* r0 = nullptr,
                 const bf16* r1 = nullptr) {
  LinearParams p{a, b, bias, out, M, N, K, 0, 0, aux, aux2, r0, r1, nullptr, 0};
  return linear_gemm<kEpi, kHeadA ? kHeadK : kRowK, kRowK>(p, s);
}

// ---- the fixed-order reductions of the backward kernels (B9, B10) ----

// Chain launches: stop at the first error.
#define IUVL_TRY(call)              \
  do {                              \
    const int err_ = (call);        \
    if (err_ != 0) return err_;     \
  } while (0)

// Column sums in fp32 (bias gradients; the LayerNorm's scale and bias
// gradients), out[c] = sum_r a[r, c], of up to four (rows, cols) matrices
// (bf16 or fp32, cols a multiple of 8) in two launches: a block sums 64
// columns of a 128-row chunk (a lane two columns, eight row lanes added in
// order) into part[job][chunk][c]; colsum_finish_kernel then adds the
// chunks in order. The same bits on every run.
constexpr int kSumRows = 128;
struct ColsumJob {
  const void* a;
  float* out;
  int cols, f32;
};
struct ColsumJobs {
  ColsumJob job[4];
};

__global__ void __launch_bounds__(256) colsum_part_kernel(const __grid_constant__ ColsumJobs jobs,
                                                          float* part, int rows,
                                                          size_t job_stride) {
  __shared__ float2 red[8][32];
  const ColsumJob& j = jobs.job[blockIdx.z];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 64 + 2 * tx, r0 = blockIdx.y * kSumRows;
  if (blockIdx.x * 64 >= j.cols) return;  // the whole block: no barrier is skipped by some
  float2 s = make_float2(0.f, 0.f);
  if (c < j.cols) {
    const int r1 = min(rows, r0 + kSumRows);
    for (int r = r0 + ty; r < r1; r += 8) {
      const size_t at = static_cast<size_t>(r) * j.cols + c;
      const float2 v = j.f32 ? *reinterpret_cast<const float2*>(static_cast<const float*>(j.a) + at)
                             : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                   static_cast<const bf16*>(j.a) + at));
      s.x += v.x;
      s.y += v.y;
    }
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < j.cols) {
    float2 t = red[0][tx];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      t.x += red[i][tx].x;
      t.y += red[i][tx].y;
    }
    *reinterpret_cast<float2*>(part + blockIdx.z * job_stride +
                               static_cast<size_t>(blockIdx.y) * j.cols + c) = t;
  }
}

// out[c] = sum over the chunks of part[job][chunk][c], in chunk order; grid
// (ceil(max cols / 256), jobs).
__global__ void __launch_bounds__(256) colsum_finish_kernel(const __grid_constant__ ColsumJobs jobs,
                                                            const float* part, int chunks,
                                                            size_t job_stride) {
  const ColsumJob& j = jobs.job[blockIdx.y];
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= j.cols) return;
  const float* p = part + blockIdx.y * job_stride + c;
  float s = p[0];
  for (int z = 1; z < chunks; ++z) s += p[static_cast<size_t>(z) * j.cols];
  j.out[c] = s;
}

// The column sums of n_jobs jobs over `rows` rows; part holds n_jobs x
// ceil(rows / 128) x max cols fp32 (ops/cuda/build.py colsum_scratch).
inline int colsums(const ColsumJobs& jobs, int n_jobs, int rows, float* part, cudaStream_t s) {
  int max_cols = 0;
  for (int i = 0; i < n_jobs; ++i) {
    if (jobs.job[i].cols % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (jobs.job[i].cols > max_cols) max_cols = jobs.job[i].cols;
  }
  const int chunks = (rows + kSumRows - 1) / kSumRows;
  const size_t stride = static_cast<size_t>(chunks) * max_cols;
  colsum_part_kernel<<<dim3((max_cols + 63) / 64, chunks, n_jobs), 256, 0, s>>>(jobs, part, rows,
                                                                               stride);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  colsum_finish_kernel<<<dim3((max_cols + 255) / 256, n_jobs), 256, 0, s>>>(jobs, part, chunks,
                                                                            stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl
