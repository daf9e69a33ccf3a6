// Whole windowed-attention module body for SAM's windowed ViT blocks:
//   qkv = x @ Wqkv^T + bqkv;  per head h: o_h = softmax(q_h k_h^T * d^-1/2
//   + relh + relw) @ v_h (fp32 softmax);  out = concat_h(o_h) @ Wo^T + bo.
// Replaces iuvl_tpu/ops/pallas/window_block.py:window_attention_block.
//
// Bound on the card: per 14x14 window ~1.1 GFLOP of products (qkv 0.74,
// attention 0.13, projection 0.25) against 0.3 MB of input; tensor-core
// bound. One window's x (196 x 768 bf16, 301 KB) exceeds a block's shared
// memory, so the qkv product is tiled over C in 64-wide slices staged in
// shared memory. The cross-head projection needs every head's output of a
// window, so one thread-block cluster of kCluster blocks owns one window
// and runs three phases separated by cluster barriers: (A) qkv into a
// wrapper-allocated scratch (N padded to a multiple of 16, L2-resident),
// each block a quarter of the columns; (B) per head (a quarter of the
// heads each), scores and softmax per 16-query tile in shared memory, o_h
// into a second scratch; (C) the projection, a quarter of the columns
// each. No atomics. At B=1 the grid is 25 clusters, 100 blocks for 132
// SMs (one block per SM: 191 KB of shared memory). Shared-memory rows are
// padded against bank conflicts, and the rel-pos features are computed
// one query row per warp with lanes over the head dim, so that their
// loads are coalesced: the first version of both phases spent most of
// its time on conflicting and scattered loads.
//
// Rounding points follow the plain version (the JAX _block_xla math), so
// that the two differ only in summation order: qkv = bf16(bf16(x @ W) +
// bf16(b)); relh/relw = bf16(q . R) with an fp32 sum; scores fp32;
// p = bf16(e / sum); o_h = bf16(p @ v); out = bf16(bf16(o @ Wo) + bf16(bo)).
#include <cooperative_groups.h>

#include "common.cuh"

namespace iuvl {
namespace cg = cooperative_groups;
namespace {

constexpr int kHd = 64;    // head dim
constexpr int kWin = 14;   // window side
constexpr int kN = kWin * kWin;
constexpr int kRT = (kN + 15) / 16;  // 13 row tiles
constexpr int kNP = kRT * 16;        // 208 padded rows
constexpr int kSlice = 64;           // C slice of x staged per step
constexpr int kSCols = (kNP + 31) / 32;
// Shared-memory row strides, padded so that the 8 rows a fragment load
// reads at once fall on different banks.
constexpr int kLdX = kSlice + 8;  // x slice (bf16)
constexpr int kLdS = kNP + 4;     // scores (fp32)
constexpr int kLdP = kNP + 8;     // probabilities (bf16)
constexpr int kCluster = 4;          // blocks per window

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads) window_block_kernel(
    const bf16* __restrict__ xw, const bf16* __restrict__ wqkv,
    const float* __restrict__ bqkv, const bf16* __restrict__ wo,
    const float* __restrict__ bo, const float* __restrict__ rh,
    const float* __restrict__ rw, bf16* qkv, bf16* obuf, bf16* __restrict__ out, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage_all = reinterpret_cast<float*>(smem);  // 8 x 256 fp32
  unsigned char* region = smem + kWarps * 256 * sizeof(float);
  // phase A view
  bf16* xs = reinterpret_cast<bf16*>(region);  // kNP x kLdX
  // phase B view
  float* relh = reinterpret_cast<float*>(region);  // kNP x kWin
  float* relw = relh + kNP * kWin;                 // kNP x kWin
  float* sbuf = relw + kNP * kWin;                 // 8 x 16 x kLdS
  bf16* pbuf = reinterpret_cast<bf16*>(sbuf + kWarps * 16 * kLdS);  // 8 x 16 x kLdP

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C3 = 3 * C;
  const int heads = C / kHd;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t win = blockIdx.x / kCluster;
  const bf16* x = xw + win * kN * C;
  bf16* qkv_w = qkv + win * kNP * C3;
  bf16* o_w = obuf + win * kNP * C;
  float* st = stage_all + warp * 256;

  // ---- phase A: qkv = x @ Wqkv^T + b, all kNP rows (pad rows: x = 0) ----
  for (int n0 = rank * 128; n0 < C3; n0 += kCluster * 128) {
    FragC acc[kRT];
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
    const int ncol = n0 + warp * 16;
    for (int k0 = 0; k0 < C; k0 += kSlice) {
      __syncthreads();
      for (int i = tid; i < kNP * (kSlice / 8); i += kThreads) {
        const int r = i / (kSlice / 8), v = i % (kSlice / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < kN) val = *reinterpret_cast<const uint4*>(x + r * C + k0 + v * 8);
        *reinterpret_cast<uint4*>(xs + r * kLdX + v * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 16) {
        FragBc fb;  // B[k][n] = Wqkv[ncol + n][k0 + kk + k]
        wmma::load_matrix_sync(fb, wqkv + static_cast<size_t>(ncol) * C + k0 + kk, C);
#pragma unroll
        for (int rt = 0; rt < kRT; ++rt) {
          FragA fa;
          wmma::load_matrix_sync(fa, xs + rt * 16 * kLdX + kk, kLdX);
          wmma::mma_sync(acc[rt], fa, fb, acc[rt]);
        }
      }
    }
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
      wmma::store_matrix_sync(st, acc[rt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ncol + e % 16;
        qkv_w[r * C3 + c] = to_bf(round_bf(st[e]) + round_bf(bqkv[c]));
      }
      __syncwarp();
    }
  }
  cluster.sync();  // every block's qkv columns are written

  // ---- phase B: attention per head ----
  const float scale = 1.f / sqrtf(static_cast<float>(kHd));  // exact 0.125
  for (int h = rank; h < heads; h += kCluster) {
    const bf16* qh = qkv_w + h * kHd;
    const bf16* kh = qh + C;
    const bf16* vh = qh + 2 * C;
    // relh/relw = bf16(q_i . R): one warp per query row, lanes over the
    // head dim so that every load is coalesced, one warp sum per entry.
    for (int i = warp; i < kN; i += kWarps) {
      const bf16* qi = qh + i * C3;
      const float q0 = to_f(qi[lane]), q1 = to_f(qi[lane + 32]);
      for (int j = 0; j < 2 * kWin; ++j) {
        const float* R = j < kWin ? rh + ((i / kWin) * kWin + j) * kHd
                                  : rw + ((i % kWin) * kWin + (j - kWin)) * kHd;
        const float s = round_bf(warp_sum(q0 * R[lane] + q1 * R[lane + 32]));
        if (lane == 0) {
          if (j < kWin) relh[i * kWin + j] = s;
          else relw[i * kWin + j - kWin] = s;
        }
      }
    }
    __syncthreads();
    float* S = sbuf + warp * 16 * kLdS;
    bf16* P = pbuf + warp * 16 * kLdP;
    for (int qt = warp; qt < kRT; qt += kWarps) {
      FragA qa[kHd / 16];
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
        wmma::load_matrix_sync(qa[kk], qh + qt * 16 * C3 + kk * 16, C3);
      for (int ct = 0; ct < kRT; ++ct) {
        FragC sc;
        wmma::fill_fragment(sc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          FragBc kb;  // B[k][n] = K[ct*16 + n][kk*16 + k]
          wmma::load_matrix_sync(kb, kh + ct * 16 * C3 + kk * 16, C3);
          wmma::mma_sync(sc, qa[kk], kb, sc);
        }
        wmma::store_matrix_sync(S + ct * 16, sc, kLdS, wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int i = qt * 16 + r;
        if (i >= kN) {
          for (int c = lane; c < kNP; c += 32) P[r * kLdP + c] = to_bf(0.f);
          continue;
        }
        float vals[kSCols];
        float mx = kNegInf;
#pragma unroll
        for (int m = 0; m < kSCols; ++m) {
          const int c = lane + 32 * m;
          vals[m] = kNegInf;
          if (c < kN) {
            vals[m] = S[r * kLdS + c] * scale + relh[i * kWin + c / kWin] + relw[i * kWin + c % kWin];
            mx = fmaxf(mx, vals[m]);
          }
        }
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int m = 0; m < kSCols; ++m) {
          const int c = lane + 32 * m;
          vals[m] = c < kN ? expf(vals[m] - mx) : 0.f;
          sum += vals[m];
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int m = 0; m < kSCols; ++m) {
          const int c = lane + 32 * m;
          if (c < kNP) P[r * kLdP + c] = to_bf(vals[m] / sum);
        }
      }
      __syncwarp();
      FragC oc[kHd / 16];
#pragma unroll
      for (int u = 0; u < kHd / 16; ++u) wmma::fill_fragment(oc[u], 0.f);
      for (int kt = 0; kt < kRT; ++kt) {
        FragA pa;
        wmma::load_matrix_sync(pa, P + kt * 16, kLdP);
#pragma unroll
        for (int u = 0; u < kHd / 16; ++u) {
          FragBr vb;  // B[k][n] = V[kt*16 + k][u*16 + n]
          wmma::load_matrix_sync(vb, vh + kt * 16 * C3 + u * 16, C3);
          wmma::mma_sync(oc[u], pa, vb, oc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kHd / 16; ++u) {
        wmma::store_matrix_sync(S, oc[u], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          o_w[(qt * 16 + e / 16) * C + h * kHd + u * 16 + e % 16] = to_bf(S[e]);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  cluster.sync();  // every head's o_h is written

  // ---- phase C: out = o @ Wo^T + bo ----
  for (int n0 = rank * 128; n0 < C; n0 += kCluster * 128) {
    FragC acc[kRT];
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
    const int ncol = n0 + warp * 16;
    for (int k = 0; k < C; k += 16) {
      FragBc fb;  // B[k][n] = Wo[ncol + n][k]
      wmma::load_matrix_sync(fb, wo + static_cast<size_t>(ncol) * C + k, C);
#pragma unroll
      for (int rt = 0; rt < kRT; ++rt) {
        FragA fa;
        wmma::load_matrix_sync(fa, o_w + rt * 16 * C + k, C);
        wmma::mma_sync(acc[rt], fa, fb, acc[rt]);
      }
    }
#pragma unroll
    for (int rt = 0; rt < kRT; ++rt) {
      wmma::store_matrix_sync(st, acc[rt], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16, c = ncol + e % 16;
        if (r < kN) out[(win * kN + r) * C + c] = to_bf(round_bf(st[e]) + round_bf(bo[c]));
      }
      __syncwarp();
    }
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// xw, out: (nW, 196, C) bf16; wqkv: (3C, C) bf16; bqkv: (3C) fp32; wo: (C, C)
// bf16; bo: (C) fp32; rh, rw: (14, 14, 64) fp32 rel-pos tables; qkv_scratch:
// (nW, 208, 3C) bf16; o_scratch: (nW, 208, C) bf16. win == 14, head_dim ==
// 64, C % 128 == 0.
extern "C" int iuvl_window_block(const void* xw, const void* wqkv, const void* bqkv,
                                 const void* wo, const void* bo, const void* rh, const void* rw,
                                 void* qkv_scratch, void* o_scratch, void* out, int n_windows,
                                 int C, int win, int head_dim, void* stream) {
  if (win != kWin || head_dim != kHd || C % 128) return static_cast<int>(cudaErrorInvalidValue);
  const size_t phase_a = kNP * kLdX * sizeof(bf16);
  const size_t phase_b = 2 * kNP * kWin * sizeof(float) +
                         kWarps * 16 * (kLdS * sizeof(float) + kLdP * sizeof(bf16));
  const size_t smem = kWarps * 256 * sizeof(float) + (phase_a > phase_b ? phase_a : phase_b);
  return launch_kernel(window_block_kernel, dim3(n_windows * kCluster), smem, stream,
                       static_cast<const bf16*>(xw), static_cast<const bf16*>(wqkv),
                       static_cast<const float*>(bqkv), static_cast<const bf16*>(wo),
                       static_cast<const float*>(bo), static_cast<const float*>(rh),
                       static_cast<const float*>(rw), static_cast<bf16*>(qkv_scratch),
                       static_cast<bf16*>(o_scratch), static_cast<bf16*>(out), C);
}
