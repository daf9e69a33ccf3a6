// SAM mask upscale + hypernetwork contraction, fused per keys row:
//   y1 = x @ W1 + b1            (C -> 4 groups (di,dj) x C/4; ConvT 2x2/s2)
//   y1 = gelu(LN_group(y1))     (LayerNorm2d per group, eps 1e-6)
//   y2_g = gelu(y1_g @ W2 + b2) (C/4 -> 4 groups (ei,ej) x C/8; ConvT 2x2/s2)
//   out[t, di, ei, dj, ej] = sum_c y2[(di,dj), (ei,ej), c] * hyper[t, c]
// Replaces iuvl_tpu/ops/pallas/mask_upscale.py:masks_upscale.
//
// Bound on the card: ~0.2 MFLOP per keys row (210 GFLOP for a 256-prompt
// chunk at 1024^2) against 512 B read and 128 B written per row; the plain
// path instead writes y1 and y2 (1.6 GB of bf16 per chunk) to device
// memory. Here every intermediate of a 64-row tile stays in shared memory
// and only the (rows, 64) logits are written. The TPU kernel's mostly-zero
// block-diagonal W2 and hypernetwork matrix (built so the MXU sees dense
// matmuls) are not carried over: W2 is applied per (di,dj) group as four
// 64 -> 128 products, and the hypernetwork contraction is 32-term dot
// products per (t, group) on the CUDA cores.
//
// The x tile arrives by cp.async (W1 fragments come from L2: loading them
// a step ahead measured slower, at the 128-register limit of two blocks
// per SM); products leave their fragments through a per-warp
// 16x16 staging tile, where each lane rounds, adds its bias (held in
// registers) and writes 8 bf16 values at once, so no fp32 copy of y1 or
// y2 is kept. That keeps a block at ~100 KB of shared memory: two blocks
// per SM, one's products overlapping the other's LayerNorm and GELUs.
// The LayerNorm gives each (row, group) 8 lanes, so that a warp works on
// 4 groups at once, and every shared-memory access moves 16 bytes.
//
// Rounding as masks_upscale_xla: y1, y2 rounded to bf16 before their bias
// (and stored in bf16 after it); LN stats in fp32 with var = E[x^2] -
// E[x]^2 (summed in another order); GELU (tanh) on bf16 values; logits
// stored as bf16.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kC = 256, kC4 = 64, kC8 = 32, kM = 4;
constexpr int kRows = 64;
constexpr int kW1Cols = 4 * kC4;   // 256, cols (di, dj, co)
constexpr int kW2Cols = 4 * kC8;   // 128, cols (ei, ej, co)
constexpr int kOutCols = kM * 16;  // 64, cols (t, di, ei, dj, ej)
// Shared-memory row strides (bf16), padded so that the rows a fragment
// load touches at once fall on different banks.
constexpr int kLdX = kC + 8;       // x
constexpr int kLd1 = kW1Cols + 8;  // y1
constexpr int kLd2 = kW2Cols + 8;  // y2
constexpr size_t kSmem = (kRows * (kLdX + kLd1 + kLd2 + kOutCols)) * sizeof(bf16) +
                         (kWarps * 256 + kM * kC8) * sizeof(float);

__device__ __forceinline__ uint4 load8(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ float at8(const uint4& v, int j) {
  return to_f(reinterpret_cast<const bf16*>(&v)[j]);
}

__global__ void __launch_bounds__(kThreads, 2) masks_upscale_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const float* __restrict__ lnw, const float* __restrict__ lnb, const bf16* __restrict__ w2,
    const bf16* __restrict__ b2, const bf16* __restrict__ hyper, bf16* __restrict__ out,
    int hw) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // kRows x kLdX
  bf16* y1b = xs + kRows * kLdX;              // kRows x kLd1
  bf16* y2b = y1b + kRows * kLd1;             // kRows x kLd2
  bf16* outs = y2b + kRows * kLd2;            // kRows x kOutCols
  float* st = reinterpret_cast<float*>(outs + kRows * kOutCols) + (threadIdx.x >> 5) * 256;
  float* hyp = reinterpret_cast<float*>(outs + kRows * kOutCols) + kWarps * 256;  // kM x kC8

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const size_t row0 = static_cast<size_t>(b) * hw + static_cast<size_t>(blockIdx.x) * kRows;
  const bf16* x = keys + row0 * kC;
  for (int i = tid; i < kRows * (kC / 8); i += kThreads) {
    const int r = i / (kC / 8), v = i % (kC / 8);
    cp_async16(xs + r * kLdX + v * 8, x + static_cast<size_t>(r) * kC + v * 8);
  }
  cp_async_commit();
  if (tid < kM * kC8) hyp[tid] = to_f(hyper[b * kM * kC8 + tid]);
  // In an epilogue a lane owns row er and columns ec..ec+7 of a 16x16 tile.
  const int er = lane >> 1, ec = (lane & 1) * 8;
  uint4 b1v[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) b1v[u] = load8(b1 + (warp * 32 + u * 16 + ec) % kC4);
  const uint4 b2v = load8(b2 + (warp * 16 + ec) % kC8);
  cp_async_wait<0>();
  __syncthreads();

  // Stage a 16x16 product tile and hand each lane its 8 values.
  auto staged = [&](const FragC& acc, float v[8]) {
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = st[er * 16 + ec + j];
    __syncwarp();
  };

  // y1 = x @ W1 + b1: 4 row tiles x 16 col tiles; warp owns col tiles 2w, 2w+1.
  {
    FragC acc[4][2];
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
      wmma::fill_fragment(acc[rt][0], 0.f);
      wmma::fill_fragment(acc[rt][1], 0.f);
    }
    for (int k = 0; k < kC; k += 16) {
      FragBr fb0, fb1;  // B[k][n] = W1[k][n]
      wmma::load_matrix_sync(fb0, w1 + k * kW1Cols + warp * 32, kW1Cols);
      wmma::load_matrix_sync(fb1, w1 + k * kW1Cols + warp * 32 + 16, kW1Cols);
#pragma unroll
      for (int rt = 0; rt < 4; ++rt) {
        FragA fa;
        wmma::load_matrix_sync(fa, xs + rt * 16 * kLdX + k, kLdX);
        wmma::mma_sync(acc[rt][0], fa, fb0, acc[rt][0]);
        wmma::mma_sync(acc[rt][1], fa, fb1, acc[rt][1]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v[8];
        staged(acc[rt][u], v);
        uint4 packed;
        bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = to_bf(round_bf(v[j]) + at8(b1v[u], j));
        *reinterpret_cast<uint4*>(y1b + (rt * 16 + er) * kLd1 + warp * 32 + u * 16 + ec) = packed;
      }
    }
  }
  __syncthreads();

  // grouped LayerNorm2d, GELU, in place: 8 lanes per (row, group), so a
  // warp normalises 4 groups at once; a lane owns columns gc..gc+7.
  const int gc = (lane & 7) * 8;
  float lw[8], lb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lw[j] = lnw[gc + j];
    lb[j] = lnb[gc + j];
  }
  for (int pair = warp * 4 + (lane >> 3); pair < kRows * 4; pair += kWarps * 4) {
    const int r = pair >> 2, g = pair & 3;
    bf16* row = y1b + r * kLd1 + g * kC4 + gc;
    const uint4 raw = load8(row);
    float v[8], s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = at8(raw, j);
      s += v[j];
      s2 += v[j] * v[j];
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / kC4;
    const float rstd = rsqrtf(s2 / kC4 - mean * mean + 1e-6f);
    uint4 packed;
    bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = to_bf(gelu_tanh(round_bf((v[j] - mean) * rstd * lw[j] + lb[j])));
    *reinterpret_cast<uint4*>(row) = packed;
  }
  __syncthreads();

  for (int g = 0; g < 4; ++g) {
    // y2_g = gelu(y1_g (64 x 64) @ W2 (64 x 128) + b2): 4 row tiles x 8 col
    // tiles; warp owns col tile w.
    FragC acc[4];
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) wmma::fill_fragment(acc[rt], 0.f);
#pragma unroll
    for (int kk = 0; kk < kC4; kk += 16) {
      FragBr fb;  // B[k][n] = W2[kk + k][n]
      wmma::load_matrix_sync(fb, w2 + kk * kW2Cols + warp * 16, kW2Cols);
#pragma unroll
      for (int rt = 0; rt < 4; ++rt) {
        FragA fa;
        wmma::load_matrix_sync(fa, y1b + rt * 16 * kLd1 + g * kC4 + kk, kLd1);
        wmma::mma_sync(acc[rt], fa, fb, acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < 4; ++rt) {
      float v[8];
      staged(acc[rt], v);
      uint4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = to_bf(gelu_tanh(round_bf(round_bf(v[j]) + at8(b2v, j))));
      *reinterpret_cast<uint4*>(y2b + (rt * 16 + er) * kLd2 + warp * 16 + ec) = packed;
    }
    __syncthreads();
    // out[r, t, di, ei, dj, ej] for this g = (di, dj): 64 rows x 4 t x 4 e.
    const int di = g >> 1, dj = g & 1;
    for (int i = tid; i < kRows * kM * 4; i += kThreads) {
      const int r = i >> 4, t = (i >> 2) & 3, e = i & 3;
      const bf16* yv = y2b + r * kLd2 + e * kC8;
      const float4* hv = reinterpret_cast<const float4*>(hyp + t * kC8);
      float s = 0.f;
#pragma unroll
      for (int c8 = 0; c8 < kC8 / 8; ++c8) {
        const uint4 y8 = load8(yv + c8 * 8);
        const float4 ha = hv[2 * c8], hb = hv[2 * c8 + 1];
        const float h8[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) s += at8(y8, j) * h8[j];
      }
      const int ei = e >> 1, ej = e & 1;
      outs[r * kOutCols + t * 16 + di * 8 + ei * 4 + dj * 2 + ej] = to_bf(s);
    }
    __syncthreads();
  }

  uint4* o = reinterpret_cast<uint4*>(out + row0 * kOutCols);
  const uint4* src = reinterpret_cast<const uint4*>(outs);
  for (int i = tid; i < kRows * kOutCols / 8; i += kThreads) o[i] = src[i];
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// keys: (B, HW, 256) bf16; w1: (256, 256) bf16, cols (di, dj, co); b1: (64)
// bf16; lnw, lnb: (64) fp32; w2: (64, 128) bf16, cols (ei, ej, co); b2: (32)
// bf16; hyper: (B, 4, 32) bf16; out: (B, HW, 64) bf16, cols (t, di, ei, dj, ej).
// HW % 64 == 0.
extern "C" int iuvl_masks_upscale(const void* keys, const void* w1, const void* b1,
                                  const void* lnw, const void* lnb, const void* w2,
                                  const void* b2, const void* hyper, void* out, int batch,
                                  int hw, void* stream) {
  if (hw % kRows) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(masks_upscale_kernel, dim3(hw / kRows, batch), kSmem, stream,
                       static_cast<const bf16*>(keys), static_cast<const bf16*>(w1),
                       static_cast<const bf16*>(b1), static_cast<const float*>(lnw),
                       static_cast<const float*>(lnb), static_cast<const bf16*>(w2),
                       static_cast<const bf16*>(b2), static_cast<const bf16*>(hyper),
                       static_cast<bf16*>(out), hw);
}
