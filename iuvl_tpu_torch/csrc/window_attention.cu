// Attention with the decomposed rel-pos bias built inside the kernel (B13):
//   s[q, key] = (q . k) d^-1/2 + relh[q, key / w] + relw[q, key % w]
//   relh[q, a] = sum_c q[q, c] Rh[q / w, a, c],  relw[q, a] = sum_c q[q, c] Rw[q % w, a, c]
//   o = bf16(softmax(s)) v
// over a square w x w grid (N = w^2) of one (batch, head). Replaces
// iuvl_tpu/ops/pallas/window_attention.py:window_rel_attention
// (_window_kernel, pallas_call in _window_forward). SAM runs it under
// attn_impl 'window' in every block: the windowed ones (25 windows x 12
// heads of N 196, w 14, at ViT-B 1024^2) and the global ones (12 heads of
// N 4096, w 64). Its backward is not a kernel in JAX either (_wra_bwd
// recomputes through the augmented XLA route); the port's autograd
// function does the same in PyTorch.
//
// Bound on the card: operations. q k^T and p v are 4 N^2 d a head (51.5
// GFLOP at the global block, 0.052 ms at 989 TFLOP/s); relh and relw add
// 4 N w d, small beside it. The TPU kernel kept a whole (window, head) in
// VMEM and built the bias with (N, N) selector matrices (M1h = q RhT masked,
// then collapsed): at N 4096 those are 64 MB each, which no SM holds. Here
// no selector is built:
// - a block of four warps owns a 64-query tile (each warp a 16-row strip)
//   and first computes its rows' relh and relw in fp32 on the CUDA cores,
//   each row against its own grid row's Rh[q / w] and grid column's
//   Rw[q % w] slice, read straight from device memory (at w 64 a tile
//   spans all 64 grid columns, so all of Rw, 512 KB, passes through L2
//   once a tile; at w 14 the slices are 25 KB);
// - the scores never leave the block: a first pass over the 64-key tiles
//   takes each row's max and sum of the online softmax, a second pass
//   recomputes the scores (the same products in the same order, so the
//   same values) and forms p = bf16(exp(s - m) / l) before p v, as the TPU
//   kernel normalises p before rounding it. That costs q k^T twice; a
//   simple design first.
// - the last tile of either side is masked (rows past N load as zero,
//   keys past N have p = 0), so N need not be a multiple of 64 (196).
//
// Rounding points follow the TPU kernel: Rh and Rw are expanded in fp32 and
// rounded to bf16 by the wrapper; relh and relw stay fp32; the scale
// multiplies the fp32 scores; softmax in fp32; p rounded to bf16; p v summed
// in fp32 and rounded once.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kWT = 64;         // query / key tile
constexpr int kWThreads = 128;  // 4 warps, each a 16-row strip
constexpr int kLdP = kWT + 8;

template <int D>
struct WinSmem {
  static constexpr int kLdT = D + 8;
  static constexpr int kLdS = (D > kWT ? D : kWT) + 4;  // scores, then o staged
  // Q, K, V tiles; scores (fp32, also staging o); p (bf16); relh, relw (fp32, kWT x w each)
  static size_t bytes(int w) {
    return 3 * kWT * kLdT * sizeof(bf16) + kWT * kLdS * sizeof(float) +
           kWT * kLdP * sizeof(bf16) + 2 * kWT * w * sizeof(float);
  }
};

// Rows [r0, r0 + kWT) of a (n, D) bf16 matrix into shared rows of stride ld;
// rows past n are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int n) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kWT * (D / 8); i += kWThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        r0 + r < n ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c)
                   : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(kWThreads) window_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ rh, const bf16* __restrict__ rw, bf16* __restrict__ o, int n, int w,
    float scale) {
  constexpr int kLdT = WinSmem<D>::kLdT, kLdS = WinSmem<D>::kLdS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kWT * kLdT;
  bf16* Vs = Ks + kWT * kLdT;
  float* S = reinterpret_cast<float*>(Vs + kWT * kLdT);
  bf16* P = reinterpret_cast<bf16*>(S + kWT * kLdS);
  float* RH = reinterpret_cast<float*>(P + kWT * kLdP);  // kWT x w
  float* RW = RH + kWT * w;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kWT, r0 = warp * 16;
  const bf16* kh = k + bh * n * D;
  const bf16* vh = v + bh * n * D;
  load_tile<D>(Qs, kLdT, q + bh * n * D, q0, n);
  __syncthreads();

  // relh, relw of the tile's rows: a thread per (table, row, a), fp32 sums
  // over the head dim in order.
  for (int i = threadIdx.x; i < 2 * kWT * w; i += kWThreads) {
    const int which = i / (kWT * w), rem = i % (kWT * w), r = rem / w, a = rem % w;
    float dot = 0.f;
    if (q0 + r < n) {
      const int qi = q0 + r, g = which ? qi % w : qi / w;
      const bf16* t = (which ? rw : rh) + (static_cast<size_t>(g) * w + a) * D;
      const bf16* x = Qs + r * kLdT;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        const uint4 tv = *reinterpret_cast<const uint4*>(t + c);
        const uint4 xv = *reinterpret_cast<const uint4*>(x + c);
        const bf16* tb = reinterpret_cast<const bf16*>(&tv);
        const bf16* xb = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += to_f(xb[j]) * to_f(tb[j]);
      }
    }
    (which ? RW : RH)[r * w + a] = dot;
  }

  // A lane owns row `row` of the warp's strip and keys half*32 .. half*32+31
  // of each key tile.
  const int row = lane >> 1, half = lane & 1, rg = r0 + row;
  float* Sw = S + r0 * kLdS;
  bf16* Pw = P + r0 * kLdP;
  // The scores of key tile k0 for the warp's strip, into Sw.
  auto scores = [&]() {
#pragma unroll
    for (int ct = 0; ct < kWT / 16; ++ct) {
      FragC sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Qs + r0 * kLdT + kk, kLdT);
        FragBc fb;  // B[c][key] = K[key][c]
        wmma::load_matrix_sync(fb, Ks + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(sc, fa, fb, sc);
      }
      wmma::store_matrix_sync(Sw + ct * 16, sc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
  };
  // s of the lane's key j of tile k0 (the bias added as the TPU kernel sums it).
  auto score = [&](int k0, int j) {
    const int c = half * 32 + j, key = k0 + c;
    if (key >= n) return kNegInf;
    const int g = key / w;
    return (Sw[row * kLdS + c] * scale + RH[rg * w + g]) + RW[rg * w + key - g * w];
  };

  float m = kNegInf, l = 0.f;
  for (int k0 = 0; k0 < n; k0 += kWT) {  // pass 1: each row's max and sum
    __syncthreads();  // the previous K tile is consumed; relh, relw are written
    load_tile<D>(Ks, kLdT, kh, k0, n);
    __syncthreads();
    scores();
    float s[32], mc = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = score(k0, j);
      mc = fmaxf(mc, s[j]);
    }
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    const float m_new = fmaxf(m, mc);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) ps += expf(s[j] - m_new);
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * expf(m - m_new) + ps;
    m = m_new;
    __syncwarp();  // Sw is read before the next tile's scores overwrite it
  }

  FragC acc[D / 16];
#pragma unroll
  for (int ct = 0; ct < D / 16; ++ct) wmma::fill_fragment(acc[ct], 0.f);
  for (int k0 = 0; k0 < n; k0 += kWT) {  // pass 2: p = bf16(exp(s - m) / l), o += p v
    __syncthreads();
    load_tile<D>(Ks, kLdT, kh, k0, n);
    load_tile<D>(Vs, kLdT, vh, k0, n);
    __syncthreads();
    scores();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float s = score(k0, j);
      Pw[row * kLdP + half * 32 + j] = to_bf(s == kNegInf ? 0.f : expf(s - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int ct = 0; ct < D / 16; ++ct) {
#pragma unroll
      for (int kk = 0; kk < kWT; kk += 16) {
        FragA pa;
        wmma::load_matrix_sync(pa, Pw + kk, kLdP);
        FragBr vb;  // B[key][c] = V[key][c]
        wmma::load_matrix_sync(vb, Vs + kk * kLdT + ct * 16, kLdT);
        wmma::mma_sync(acc[ct], pa, vb, acc[ct]);
      }
    }
    __syncwarp();  // Pw is read before the next tile writes it
  }

  // o for the warp's rows, staged through its score rows.
#pragma unroll
  for (int ct = 0; ct < D / 16; ++ct)
    wmma::store_matrix_sync(Sw + ct * 16, acc[ct], kLdS, wmma::mem_row_major);
  __syncwarp();
  bf16* oh = o + bh * n * D;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    if (q0 + r0 + r < n) oh[static_cast<size_t>(q0 + r0 + r) * D + c] = to_bf(Sw[r * kLdS + c]);
  }
}

template <int D>
int window_forward(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                   void* o, int bh, int n, int w, float scale, void* stream) {
  const size_t smem = WinSmem<D>::bytes(w);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attn_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attn_kernel<D><<<dim3((n + kWT - 1) / kWT, bh), kWThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(rh), static_cast<const bf16*>(rw), static_cast<bf16*>(o), n, w,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q, k, v, o: (BH, N, d) bf16, d 64 or 80; rh, rw: (w, w, d) bf16, the expanded
// tables rounded to bf16; N = w * w; scale = d^-1/2.
extern "C" int iuvl_window_attention(const void* q, const void* k, const void* v, const void* rh,
                                     const void* rw, void* o, int bh, int n, int d, int w,
                                     float scale, void* stream) {
  if (w < 1 || w * w != n || bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return window_forward<64>(q, k, v, rh, rw, o, bh, n, w, scale, stream);
    case 80: return window_forward<80>(q, k, v, rh, rw, o, bh, n, w, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
