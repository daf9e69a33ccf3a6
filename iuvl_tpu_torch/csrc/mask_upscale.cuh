// SAM mask upscale + hypernetwork contraction, fused per keys row:
//   y1 = x @ W1 + b1            (C -> 4 groups (di,dj) x C/4; ConvT 2x2/s2)
//   y1 = gelu(LN_group(y1))     (LayerNorm2d per group, eps 1e-6)
//   y2_g = gelu(y1_g @ W2 + b2) (C/4 -> 4 groups (ei,ej) x C/8; ConvT 2x2/s2)
//   out[t, di, ei, dj, ej] = sum_c y2[(di,dj), (ei,ej), c] * hyper[t, c]
// Replaces iuvl_tpu/ops/pallas/mask_upscale.py:masks_upscale.
//
// Bound on the card: ~0.2 MFLOP of products per keys row (210 GFLOP for a
// 256-prompt chunk at 1024^2, 0.21 ms on the tensor cores) against 512 B
// read and 128 B written per row (0.67 GB, 0.20 ms); besides the products,
// each row takes 768 GELUs (two SFU operations each: ~0.44 ms of the
// card's 16 SFU results a cycle an SM for a chunk) and its LayerNorms.
// The TPU kernel's mostly-zero block-diagonal W2 and hypernetwork matrix
// (built so the MXU sees dense matmuls) are not carried over.
//
// Design: persistent blocks of two warpgroups, one block an SM, hold W1
// (128 KB) and W2 (16 KB) in shared memory for the whole call, transposed
// once into the K-major core-matrix layout wgmma reads (wgmma.cuh). Each
// warpgroup walks its own 64-row tiles (a tile lies in one prompt); its x
// tile arrives by cp.async into its own slot, and the next tile's copy is
// issued as soon as the y1 product has read the slot, so it overlaps the
// rest of the tile. Everything after the copy stays in registers:
// - y1 (64 x 256) is two wgmma m64n128k16 chains from shared memory
//   (groups 0-1, 2-3); the first half's sums are rounded to bf16 and b1
//   added in bf16 (the rounding of the plain version) while the second
//   half computes; kept packed: a lane holds 2 rows x 64 columns.
// - Each (di, dj) group's LayerNorm2d runs on those fragments: the 64
//   columns of a row are spread over a quad of lanes, whose sums and
//   sums of squares (fp32) meet by two shuffles; GELU (x * sigmoid(2 u),
//   the tanh form rewritten, ex2 and rcp on the SFU) on the bf16-rounded
//   values, packed straight into the register A operand of y2_g = y1_g W2
//   (two wgmma m64n64k16 chains, A from registers; the first half's
//   GELUs and contraction run while the second computes).
// - y2_g's sums are rounded, b2 added, GELU, and packed as the A operand
//   of the hypernetwork contraction: per (ei, ej) an mma.sync m16n8k16 of
//   y2's 32 channels against the prompt's hyper (B operand from device
//   memory, tokens 4 padded to 8 with zeros).
// - The 64 logits of a row are staged in a per-warpgroup tile in the
//   (t, di, ei, dj, ej) column order and leave in 16-byte stores.
// No block barrier after the weights are staged; a warpgroup syncs only
// its own 128 threads around its slot.
//
// C5: any HW >= 1. The last tile of a prompt is masked: rows past HW are
// zero-filled in the copy (their logits are computed and never written).
//
// Rounding as masks_upscale_xla: y1, y2 rounded to bf16 before their bias
// (and kept in bf16 after it); LN stats in fp32 with var = E[x^2] -
// E[x]^2 (summed in another order); GELU (tanh) on bf16 values; logits
// summed in fp32 and stored as bf16.
//
// The kernel lives in this header so that B16 (decode_chunk.cu) runs it as
// its last stage; an epilogue chosen by a template argument stores B6's
// bf16 logits in (t, di, ei, dj, ej) order, or B16's fp32 ones in (di, dj,
// ei, ej, t) order straight from the contraction's registers (8 bytes a
// lane: a row's fp32 logits do not fit the staging tile beside the
// resident weights). mask_upscale.cu holds B6's C entry.
#pragma once

#include "wgmma.cuh"

namespace iuvl {
namespace {
namespace upscale {

constexpr int kC = 256, kC4 = 64, kC8 = 32, kM = 4;
constexpr int kRows = 64;                // rows a tile: one wgmma's M
constexpr int kGroups = 2;               // warpgroups a block
constexpr int kUpThreads = kGroups * 128;
constexpr int kOutCols = kM * 16;        // 64 logits a row, cols (t, di, ei, dj, ej)
constexpr int kLdO = kOutCols + 8;       // staged logits' row pitch: rows on distinct banks
constexpr size_t kW1Bytes = size_t{kC} * kC * 2;         // W1^T: (256 out) x (256 in)
constexpr size_t kW2Bytes = size_t{4 * kC8} * kC4 * 2;   // W2^T: (128 out) x (64 in)
constexpr size_t kXBytes = size_t{kRows} * kC * 2;       // a warpgroup's x tile
constexpr size_t kOBytes = size_t{kRows} * kLdO * 2;     // a warpgroup's logits
constexpr size_t kUpSmem = kW1Bytes + kW2Bytes + kGroups * (kXBytes + kOBytes);
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// A (K x N) row-major bf16 matrix into shared memory as its transpose, an
// (N x K) K-major core-matrix tile: each thread moves 8 x 8 blocks, eight
// 16-byte loads, a register transpose, eight 16-byte stores.
template <int K, int N>
__device__ __forceinline__ void stage_transposed(bf16* dst, const bf16* src, int tid,
                                                 int threads) {
  for (int i = tid; i < (K / 8) * (N / 8); i += threads) {
    const int kb = i / (N / 8), nb = i % (N / 8);
    uint4 in[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      in[r] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(8 * kb + r) * N) + nb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;  // column j's half of its word
      uint32_t w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t a = reinterpret_cast<const uint32_t*>(&in[2 * m])[j >> 1];
        const uint32_t b = reinterpret_cast<const uint32_t*>(&in[2 * m + 1])[j >> 1];
        w[m] = __byte_perm(a, b, sel);
      }
      *reinterpret_cast<uint4*>(dst + cm_index<K>(8 * nb + j, 8 * kb)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// gelu_tanh(x) = 0.5 x (1 + tanh(u)) = x / (1 + exp(-2 u)), u = sqrt(2 / pi)
// (x + 0.044715 x^3): one ex2 and one rcp on the SFU, no cancellation for
// negative x (relative error ~1e-6 against the tanh form in fp32).
__device__ __forceinline__ float gelu_fast(float x) {
  constexpr float k0 = -2.f * 0.7978845608028654f * kLog2e;
  constexpr float k1 = k0 * 0.044715f;
  return x * rcp_approx(1.f + ex2(x * fmaf(k1, x * x, k0)));
}

__device__ __forceinline__ uint32_t gelu2(uint32_t v) {
  const float2 f = __bfloat1622float2(bf2(v));
  return pack_bf16(gelu_fast(f.x), gelu_fast(f.y));
}

// gelu(bf16(LayerNorm2d(y1_g))) of group g (y1p tiles 8 g .. 8 g + 7) as
// the A operand of y2_g = y1_g W2: depth step kc covers the group's columns
// 16 kc .. 16 kc + 15. The 64 columns of a row lie in the lane's quad.
__device__ __forceinline__ void ln_gelu(uint32_t (&a)[4][4], const uint32_t (&y1p)[32][2], int g,
                                        const float* lnw, const float* lnb) {
  const int q2 = 2 * (threadIdx.x & 3);
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = __bfloat1622float2(bf2(y1p[8 * g + jj][h]));
      sum[h] += v.x + v.y;
      sq[h] += v.x * v.x + v.y * v.y;
    }
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], o);
      sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], o);
    }
    mean[h] = sum[h] / kC4;
    rstd[h] = rsqrtf(sq[h] / kC4 - mean[h] * mean[h] + kLnEps);
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int c = 16 * kc + 8 * p + q2;
      const float2 w = __ldg(reinterpret_cast<const float2*>(lnw + c));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(lnb + c));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = __bfloat1622float2(bf2(y1p[8 * g + 2 * kc + p][h]));
        a[kc][2 * p + h] = gelu2(pack_bf16((v.x - mean[h]) * rstd[h] * w.x + bb.x,
                                           (v.y - mean[h]) * rstd[h] * w.y + bb.y));
      }
    }
}

// The hypernetwork contraction of y2_g's half hf (columns 64 hf .. 64 hf +
// 63: (ei, ej) = e = 2 hf, 2 hf + 1, 32 channels each; c the half's fp32
// sums): bias b2, GELU, bf16, then per e an mma.sync against the prompt's
// hyper (hb), and the lane's logits (tokens q2, q2 + 1 of rows g8, g8 + 8)
// staged in sO (the warp's 16 rows) at columns (t, di, ei, dj, ej); kF32:
// stored in fp32 at fo (the warp's first row of logits), columns (di, dj,
// ei, ej, t), rows at or past `valid` dropped.
template <bool kF32>
__device__ __forceinline__ void hyper_half(bf16* sO, float* fo, int valid, const float (&c)[32],
                                           const uint32_t (&hb)[2][2], const bf16* b2, int g,
                                           int hf) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, q = lane & 3, q2 = 2 * q;
#pragma unroll
  for (int el = 0; el < 2; ++el) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      uint32_t ya[4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int j = 4 * el + 2 * kc + p;  // the half's 8-column tile
        const __nv_bfloat162 bias =
            bf2(__ldg(reinterpret_cast<const uint32_t*>(b2 + 8 * (j & 3) + q2)));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ya[2 * p + h] = gelu2(u32(__hadd2(
              __floats2bfloat162_rn(c[4 * j + 2 * h], c[4 * j + 2 * h + 1]), bias)));
      }
      mma16816(o, ya, hb[kc][0], hb[kc][1]);
    }
    if (q >= 2) continue;  // tokens q2, q2 + 1 (t >= 4 is padding)
    const int e = 2 * hf + el;
    if constexpr (kF32) {  // the two tokens are adjacent columns
      const int col = 16 * g + 4 * e + q2;
      if (g8 < valid)
        *reinterpret_cast<float2*>(fo + g8 * kOutCols + col) = make_float2(o[0], o[1]);
      if (g8 + 8 < valid)
        *reinterpret_cast<float2*>(fo + (g8 + 8) * kOutCols + col) = make_float2(o[2], o[3]);
    } else {
      const int col = (g >> 1) * 8 + (e >> 1) * 4 + (g & 1) * 2 + (e & 1);
      sO[g8 * kLdO + q2 * 16 + col] = to_bf(o[0]);
      sO[g8 * kLdO + (q2 + 1) * 16 + col] = to_bf(o[1]);
      sO[(g8 + 8) * kLdO + q2 * 16 + col] = to_bf(o[2]);
      sO[(g8 + 8) * kLdO + (q2 + 1) * 16 + col] = to_bf(o[3]);
    }
  }
}

// y1p[jo + j] = bf16(bf16(x W1) + b1) of the 8-column tiles jo + j (j < 16)
// from a half's sums: columns 8 j + q2, +1 of rows g8 (y1p[.][0]) and g8 +
// 8 (y1p[.][1]); column c takes b1[c % 64].
__device__ __forceinline__ void y1_pack(uint32_t (&y1p)[32][2], const float (&acc)[64], int jo,
                                        const bf16* b1) {
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 bias =
        bf2(__ldg(reinterpret_cast<const uint32_t*>(b1 + 8 * (j & 7) + q2)));
    y1p[jo + j][0] = u32(__hadd2(__floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]), bias));
    y1p[jo + j][1] = u32(__hadd2(__floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]), bias));
  }
}

// kF32: B16's epilogue (out is fp32); else B6's (out is bf16).
template <bool kF32>
__global__ void __launch_bounds__(kUpThreads, 1) masks_upscale_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const float* __restrict__ lnw, const float* __restrict__ lnb, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, const bf16* __restrict__ hyper, void* __restrict__ out,
    int batch, int hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW1 = reinterpret_cast<bf16*>(smem);
  bf16* sW2 = reinterpret_cast<bf16*>(smem + kW1Bytes);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g8 = lane >> 2, q2 = 2 * (lane & 3);
  bf16* sX = reinterpret_cast<bf16*>(smem + kW1Bytes + kW2Bytes + wg * kXBytes);
  bf16* sO = reinterpret_cast<bf16*>(smem + kW1Bytes + kW2Bytes + kGroups * kXBytes +
                                     wg * kOBytes) + 16 * warp * kLdO;  // the warp's rows

  const int per = (hw + kRows - 1) / kRows, total = batch * per;
  const int stride = gridDim.x * kGroups;
  auto load_x = [&](int tile) {  // rows past hw zero-filled
    const int r0 = (tile % per) * kRows, valid = min(kRows, hw - r0);
    const bf16* src = keys + (static_cast<size_t>(tile / per) * hw + r0) * kC;
    for (int i = wt; i < kRows * (kC / 8); i += 128) {
      // Eight neighbouring threads fill one 128-byte core matrix.
      const int r = (i & 7) + 8 * (i >> 8), c = ((i >> 3) & 31) * 8;
      cp_async16_zfill(sX + cm_index<kC>(r, c),
                       src + static_cast<size_t>(r < valid ? r : 0) * kC + c, r < valid);
    }
    cp_async_commit();
  };
  int tile = blockIdx.x * kGroups + wg;
  if (tile < total) load_x(tile);
  stage_transposed<kC, kC>(sW1, w1, tid, kUpThreads);
  stage_transposed<kC4, 4 * kC8>(sW2, w2, tid, kUpThreads);
  fence_async_smem();
  __syncthreads();

  // Descriptors: the x slot; W1^T's halves (rows 0-127, 128-255: 64 KB
  // apart); W2^T's halves (rows 0-63, 64-127: 8 KB apart).
  const uint64_t dx = wg_desc<kC>(sX), dw1 = wg_desc<kC>(sW1), dw2 = wg_desc<kC4>(sW2);
  for (; tile < total; tile += stride) {
    const int b = tile / per, r0 = (tile % per) * kRows;
    cp_async_wait<0>();
    fence_async_smem();
    named_bar(1 + wg, 128);  // the tile has landed for the whole warpgroup

    // y1 = x W1 in two halves of 128 columns (groups 0-1, 2-3), 16 steps of
    // m64n128k16 each: the first half's epilogue overlaps the second's
    // products.
    uint32_t y1p[32][2];
    {
      float acc0[64], acc1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      wg_fence_acc(acc0);
      wg_fence_acc(acc1);
      wg_fence();
#pragma unroll
      for (int s = 0; s < kC / 16; ++s) wgmma_ss_n128(acc0, dx + 16 * s, dw1 + 16 * s, 1);
      wg_commit();
#pragma unroll
      for (int s = 0; s < kC / 16; ++s) wgmma_ss_n128(acc1, dx + 16 * s, dw1 + 4096 + 16 * s, 1);
      wg_commit();
      wg_wait<1>();
      wg_fence_acc(acc0);
      y1_pack(y1p, acc0, 0, b1);
      wg_wait<0>();
      wg_fence_acc(acc1);
      named_bar(1 + wg, 128);  // every warp's products have read the slot
      if (tile + stride < total) load_x(tile + stride);
      y1_pack(y1p, acc1, 16, b1);
    }
    // The prompt's hyper as the B operand of the contraction: B[c][t] =
    // hyper[t][c] for the lane's token t = g8 (t >= 4: zero).
    uint32_t hb[2][2];
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        hb[kc][u] = g8 < kM ? __ldg(reinterpret_cast<const uint32_t*>(
                                  hyper + (static_cast<size_t>(b) * kM + g8) * kC8 + 16 * kc +
                                  8 * u + q2))
                            : 0u;

    // kF32: the warp's 16 rows of logits in out, the rows of them in hw.
    const int valid = hw - r0 - 16 * warp;
    float* fo = static_cast<float*>(out) + (static_cast<size_t>(b) * hw + r0 + 16 * warp) *
                                               kOutCols;

    // Per (di, dj) group g: y2_g = gelu(LN(y1_g)) W2 in two halves of 64
    // columns (m64n64k16, A from registers); the first half's GELUs and
    // contraction run while the second computes.
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t a[4][4];
      ln_gelu(a, y1p, g, lnw, lnb);
      float c0[32], c1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) c0[i] = c1[i] = 0.f;
      wg_fence_acc(c0);
      wg_fence_acc(c1);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs_n64(c0, a[kc], dw2 + 16 * kc, 1);
      wg_commit();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) wgmma_rs_n64(c1, a[kc], dw2 + 512 + 16 * kc, 1);
      wg_commit();
      wg_wait<1>();
      wg_fence_acc(c0);
      hyper_half<kF32>(sO, fo, valid, c0, hb, b2, g, 0);
      wg_wait<0>();
      wg_fence_acc(c1);
      hyper_half<kF32>(sO, fo, valid, c1, hb, b2, g, 1);
    }
    if constexpr (!kF32) {
      __syncwarp();
      // The warp's 16 rows of logits, 16 bytes a lane at a time; rows past
      // hw dropped.
      bf16* ob = static_cast<bf16*>(out);
#pragma unroll
      for (int i = lane; i < 16 * (kOutCols / 8); i += 32) {
        const int r = i / (kOutCols / 8), c = (i % (kOutCols / 8)) * 8;
        const int row = r0 + 16 * warp + r;
        if (row < hw)
          *reinterpret_cast<uint4*>(ob + (static_cast<size_t>(b) * hw + row) * kOutCols + c) =
              *reinterpret_cast<const uint4*>(sO + r * kLdO + c);
      }
      __syncwarp();
    }
  }
}

// Launch the kernel (kF32: B16's fp32 epilogue into out (B, HW, 64) fp32;
// else B6's bf16 one) on stream st; arguments as iuvl_masks_upscale's.
template <bool kF32>
int masks_upscale_run(const bf16* keys, const bf16* w1, const bf16* b1, const float* lnw,
                      const float* lnb, const bf16* w2, const bf16* b2, const bf16* hyper,
                      void* out, int batch, int hw, cudaStream_t st) {
  if (batch < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = batch * ((hw + kRows - 1) / kRows);
  const int grid = min(device_info().sms, (tiles + kGroups - 1) / kGroups);
  const cudaError_t err =
      cudaFuncSetAttribute(masks_upscale_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kUpSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  masks_upscale_kernel<kF32><<<grid, kUpThreads, kUpSmem, st>>>(keys, w1, b1, lnw, lnb, w2, b2,
                                                               hyper, out, batch, hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace upscale
}  // namespace
}  // namespace iuvl

