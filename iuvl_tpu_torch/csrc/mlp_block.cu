// Fused ViT block tail: out = x1 + gelu(LN(x1) @ W1^T + b1) @ W2^T + b2,
// x1 = x + a.  Replaces iuvl_tpu/ops/pallas/mlp_block.py:block_tail.
//
// Bound on the card: 2*T*C*4C*2 FLOPs (38.7 GFLOP for ViT-B at 1024^2) on
// the tensor cores, against one read of x, a and one write of out. The TPU
// kernel kept the (rows, 4C) hidden in VMEM; a 32-row tile's hidden
// (32 x 3072 bf16 = 196 KB) plus its inputs does not fit a block's shared
// memory, so the hidden dimension is streamed in chunks of 128: h_chunk =
// y @ W1[j:j+128]^T -> bias, GELU -> acc += h_chunk @ W2[:, j:j+128]^T, with
// the 32 x C fp32 accumulator held in registers (each warp owns C/8
// columns). The 4C hidden never reaches device memory.
//
// Every block reads both weight matrices (9.4 MB at ViT-B) once, so with
// 128 blocks the kernel is bound by L2 bandwidth, not by the tensor cores.
// The weights therefore stream through shared memory as one sequence of
// tiles per block (per hidden chunk: C/128 tiles of W1, 128 hidden x 128 k,
// then 8 tiles of W2^T, 16 k x C out) in a ring of shared-memory slots
// filled by cp.async, with up to three tiles in flight while the tensor
// cores work on the current one. W2 comes transposed (H, C) so that a W2
// tile is 16 contiguous rows rather than C rows of 32 bytes. Rows of
// every shared-memory operand are padded by 16 bytes so that the fragment
// loads do not conflict on banks.
//
// Rounding points follow _tail_xla: residual add in bf16; LN in fp32 with
// the fast variance max(E[x^2]-E[x]^2, 0); h rounded to bf16 before +b1;
// tanh GELU on the bf16 value; the MLP output rounded before +b2.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kRows = 32;            // token rows per block
constexpr int kChunk = 128;          // hidden columns per streamed chunk
constexpr int kK1 = 128;             // depth of a W1 tile
constexpr int kK2 = 16;              // depth of a W2 tile
constexpr int kLd1 = kK1 + 8;        // padded shared-memory rows (bf16)
constexpr int kLdH = kChunk + 8;
constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper

template <int C>
struct TailSmem {
  static constexpr int kLdY = C + 8;  // also the padded row of a W2^T tile
  static constexpr int kSlot = (kChunk * kLd1 > kK2 * kLdY ? kChunk * kLd1 : kK2 * kLdY);  // bf16
  static constexpr size_t kYBytes = kRows * kLdY * sizeof(bf16);
  static constexpr size_t kHsBytes = kRows * kChunk * sizeof(float);
  static constexpr size_t kHbBytes = kRows * kLdH * sizeof(bf16);
  static constexpr size_t kRest = kYBytes + kHsBytes + kHbBytes;
  static constexpr size_t kFit = (kSmemMax - kRest) / (kSlot * sizeof(bf16));
  static constexpr int kStages = kFit < 4 ? static_cast<int>(kFit) : 4;  // 4, 4, 3 for C = 768, 1024, 1280
  static_assert(kStages >= 2, "shared memory");
  static constexpr size_t kBytes = kStages * kSlot * sizeof(bf16) + kRest;
};

template <int NT>  // output column tiles per warp: C = NT * 128
__global__ void __launch_bounds__(kThreads) block_tail_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ a,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1,
    const bf16* __restrict__ w2t, const bf16* __restrict__ b2,
    bf16* __restrict__ out, int hidden, float eps) {
  constexpr int C = NT * 128;
  using L = TailSmem<C>;
  constexpr int kT1 = C / kK1;          // W1 tiles per chunk
  constexpr int kTiles = kT1 + kChunk / kK2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);                                 // kRows x kLdY
  float* hs = reinterpret_cast<float*>(smem + L::kYBytes);                  // kRows x kChunk
  bf16* hb = reinterpret_cast<bf16*>(smem + L::kYBytes + L::kHsBytes);      // kRows x kLdH
  bf16* ring = reinterpret_cast<bf16*>(smem + L::kRest);                    // kStages slots

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(blockIdx.x) * kRows * C;
  const int total = (hidden / kChunk) * kTiles;

  // Tile s: chunk j = s / kTiles; part p < kT1 is W1[j*128 + n][p*kK1 + k]
  // at slot[n * kLd1 + k]; part kT1 + q is W2^T[j*128 + q*kK2 + k][n] at
  // slot[k * kLdY + n].
  auto load_tile = [&](int s) {
    bf16* slot = ring + (s % L::kStages) * L::kSlot;
    const int j = s / kTiles, p = s % kTiles;
    if (p < kT1) {
      const bf16* src = w1 + static_cast<size_t>(j * kChunk) * C + p * kK1;
      for (int i = tid; i < kChunk * (kK1 / 8); i += kThreads) {
        const int n = i / (kK1 / 8), v = i % (kK1 / 8);
        cp_async16(slot + n * kLd1 + v * 8, src + static_cast<size_t>(n) * C + v * 8);
      }
    } else {
      const bf16* src = w2t + static_cast<size_t>(j * kChunk + (p - kT1) * kK2) * C;
      for (int i = tid; i < kK2 * (C / 8); i += kThreads) {
        const int k = i / (C / 8), v = i % (C / 8);
        cp_async16(slot + k * L::kLdY + v * 8, src + static_cast<size_t>(k) * C + v * 8);
      }
    }
  };
  // One copy group per tile (empty past the end), kStages - 1 in flight;
  // the first ones load during the LayerNorm.
  auto prefetch = [&](int s) {
    if (s < total) load_tile(s);
    cp_async_commit();
  };
  for (int s = 0; s < L::kStages - 1; ++s) prefetch(s);

  for (int i = tid; i < kRows * C; i += kThreads)
    ys[(i / C) * L::kLdY + i % C] = to_bf(to_f(x[base + i]) + to_f(a[base + i]));
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps) {  // ys: x1 -> LN(x1), in place
    bf16* row = ys + r * L::kLdY;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f(row[c]);
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / C;
    const float rstd = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);
    for (int c = lane; c < C; c += 32)
      row[c] = to_bf((to_f(row[c]) - mu) * (rstd * scale[c]) + bias[c]);
  }

  FragC acc[2][NT];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[rt][t], 0.f);
  // h-chunk tiles: 2 row tiles x 8 column tiles; warp -> (warp / 4, 2 tiles).
  const int hrt = warp >> 2, hct = (warp & 3) * 2;
  FragC hc[2];

  for (int s = 0; s < total; ++s) {
    cp_async_wait<L::kStages - 2>();  // tile s has landed (this thread's copies) ...
    __syncthreads();  // ... and everyone's; ys and hb are written; tile s - 1 is consumed,
    prefetch(s + L::kStages - 1);  // so its slot takes tile s + kStages - 1
    const bf16* slot = ring + (s % L::kStages) * L::kSlot;
    const int j = s / kTiles, p = s % kTiles;
    if (p < kT1) {
      if (p == 0) {
        wmma::fill_fragment(hc[0], 0.f);
        wmma::fill_fragment(hc[1], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < kK1; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, ys + hrt * 16 * L::kLdY + p * kK1 + kk, L::kLdY);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          FragBc fb;  // B[k][n] = W1[j*128 + (hct+u)*16 + n][p*kK1 + kk + k]
          wmma::load_matrix_sync(fb, slot + (hct + u) * 16 * kLd1 + kk, kLd1);
          wmma::mma_sync(hc[u], fa, fb, hc[u]);
        }
      }
      if (p == kT1 - 1) {  // chunk's h complete: bias, GELU -> hb
#pragma unroll
        for (int u = 0; u < 2; ++u)
          wmma::store_matrix_sync(hs + hrt * 16 * kChunk + (hct + u) * 16, hc[u], kChunk,
                                  wmma::mem_row_major);
        __syncthreads();
        for (int i = tid; i < kRows * kChunk; i += kThreads) {
          const int r = i / kChunk, c = i % kChunk;
          const float h = round_bf(round_bf(hs[i]) + to_f(b1[j * kChunk + c]));
          hb[r * kLdH + c] = to_bf(gelu_tanh(h));
        }
      }
    } else {
      const int k0 = (p - kT1) * kK2;
      FragA fa0, fa1;
      wmma::load_matrix_sync(fa0, hb + k0, kLdH);
      wmma::load_matrix_sync(fa1, hb + 16 * kLdH + k0, kLdH);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        FragBr fb;  // B[k][n] = W2^T[j*128 + k0 + k][(warp*NT + t)*16 + n]
        wmma::load_matrix_sync(fb, slot + (warp * NT + t) * 16, L::kLdY);
        wmma::mma_sync(acc[0][t], fa0, fb, acc[0][t]);
        wmma::mma_sync(acc[1][t], fa1, fb, acc[1][t]);
      }
    }
  }

  float* st = hs + warp * 256;  // hs is free now (last read before the W2 tiles)
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      wmma::store_matrix_sync(st, acc[rt][t], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = (warp * NT + t) * 16 + e % 16;
        const size_t g = base + r * C + c;
        const float x1 = round_bf(to_f(x[g]) + to_f(a[g]));
        const float m = round_bf(round_bf(st[e]) + to_f(b2[c]));
        out[g] = to_bf(x1 + m);
      }
      __syncwarp();
    }
  }
}

template <int NT>
int launch_tail(dim3 grid, void* stream, const void* x, const void* a, const void* scale,
                const void* bias, const void* w1, const void* b1, const void* w2t,
                const void* b2, void* out, int H, float eps) {
  return launch_kernel(block_tail_kernel<NT>, grid, TailSmem<NT * 128>::kBytes, stream,
                       static_cast<const bf16*>(x), static_cast<const bf16*>(a),
                       static_cast<const float*>(scale), static_cast<const float*>(bias),
                       static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
                       static_cast<const bf16*>(w2t), static_cast<const bf16*>(b2),
                       static_cast<bf16*>(out), H, eps);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// x, a, out: (T, C) bf16; scale, bias: (C) fp32; w1: (H, C) bf16; b1: (H)
// bf16; w2t: (H, C) bf16, the second weight transposed; b2: (C) bf16.
// T % 32 == 0, C in {768, 1024, 1280}, H % 128 == 0.
extern "C" int iuvl_block_tail(const void* x, const void* a, const void* scale,
                               const void* bias, const void* w1, const void* b1,
                               const void* w2t, const void* b2, void* out, int T, int C,
                               int H, float eps, void* stream) {
  if (T % kRows || H % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(T / kRows);
  switch (C) {
    case 768: return launch_tail<6>(grid, stream, x, a, scale, bias, w1, b1, w2t, b2, out, H, eps);
    case 1024: return launch_tail<8>(grid, stream, x, a, scale, bias, w1, b1, w2t, b2, out, H, eps);
    case 1280: return launch_tail<10>(grid, stream, x, a, scale, bias, w1, b1, w2t, b2, out, H, eps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* iuvl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
