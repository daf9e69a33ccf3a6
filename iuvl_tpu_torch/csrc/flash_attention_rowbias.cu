// Flash attention with the decomposed rel-pos bias inside the kernel,
// forward (with the per-row logsumexp) and backward, in two flavours that
// compute one function:
//   s = q k^T + bias,  o = softmax(s) v,  lse = logsumexp(s)   (q pre-scaled)
// - B2b, indexed bias: bias[q, key] = relh[q, key / w] + relw[q, key % w].
//   Replaces iuvl_tpu/ops/pallas/flash_attention.py:flash_attention_rowbias
//   (_flash_rb_forward, _flash_rb_backward).
// - B14, expander bias: bias = relh eh + relw ew for any (h, N) and (w, N)
//   expanders (one-hot on the SAM path). Replaces
//   iuvl_tpu/ops/pallas/flash_attention.py:flash_attention_relpos
//   (_flash_rp_forward, _flash_rp_backward).
// The backward returns dq, dk, dv and the cotangents of relh and relw:
//   ds = p (do v^T - rowsum(do o)),  dq = ds k,  dk = ds^T q,  dv = p^T do,
//   [drelh | drelw] = ds [eh | ew]^T   (for B2b the one-hot [eh | ew] that
//   the indices describe, built in shared memory).
// SAM runs them under attn_impl 'rowbias' (B2b) and 'pallas_rp' (B14) in
// every block: windowed (25 windows x 12 heads of N 196, h = w = 14 at
// ViT-B 1024^2) and global (12 heads of N 4096, h = w = 64).
//
// Bound on the card: operations. The forward needs 4 N^2 d a head (51.5
// GFLOP for ViT-B's global block, 0.052 ms at 989 TFLOP/s) and the
// backward 2 N^2 (3 d + 2 d) (s once from the lse, then dp, dq, dk, dv:
// 129 GFLOP, 0.130 ms); the N x N scores must never reach device memory.
// The TPU grid walked (head, q block, k block) in order with VMEM
// accumulators. Here, as in B11 (flash_attention_train.cu), one block of
// four warps owns a 64-row tile and loops over the other side's 64-row
// tiles, each warp a 16-row strip; the last tile of either side is masked
// (rows past N load as zero, keys past N score -inf, queries past N have
// p = 0), so N need not be a multiple of 64 (196 in the windows).
// - Forward: a block per query tile keeps its running output in shared
//   memory (fp32, rescaled per row by the online softmax's alpha). B2b adds
//   the bias from the query tile's relh and relw rows in shared memory as it
//   reads the scores (two adds a score). B14 adds relh eh + relw ew as one
//   more tensor-core product into the score accumulators, depth h + w
//   padded to 16, skipping the 16-row groups of the expander tile that are
//   zero for this key tile (with one-hot expanders 3 of 8 skipped at N 4096): the
//   tile loads in 16-byte pieces and sets a bit per group in use.
// - Backward: one pass, a block per key tile looping over the query tiles,
//   so s and dp are computed once (not twice as in B11's two passes). dk
//   and dv stay in registers; dq, drelh and drelw are sums over key tiles,
//   so each block adds its share [dq | drelh | drelw] += ds [k | e^T] to
//   fp32 accumulators in device memory with atomics (zero groups of e
//   skipped), each block starting at another query tile so that blocks do
//   not add to the same rows at once. drelh and drelw are never (N, N).
//   The order of the atomic adds changes from run to run.
//
// Rounding points follow the TPU kernels: s, the bias and the softmax in
// fp32; the unnormalised p = exp(s - m) rounded to bf16 for p v; o =
// bf16(acc / l); lse = m + log(l); in the backward p = exp(s - lse) in
// fp32, ds rounded to bf16 before the products dq, dk and the bias
// cotangents, dv from bf16(p); dk, dv rounded once; dq, drelh and drelw
// returned as fp32 sums (the wrapper rounds them, as the JAX wrappers do).
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kRT = 128;      // threads: 4 warps, each a 16-row strip
constexpr int kT = 64;        // query / key tile
constexpr int kLdS = kT + 4;  // fp32 score rows
constexpr int kLdP = kT + 8;  // bf16 probability rows, expander rows

// Shared-memory layout of both kernels: D the head dim (q, k, v, o), ka
// the bias depth h + w rounded up to 16.
template <int D>
struct RbSmem {
  static constexpr int kLdT = D + 8;
  static constexpr size_t kTile = kT * kLdT * sizeof(bf16);
  static size_t ra(int ka) { return kT * (ka + 8) * sizeof(bf16); }
  static size_t e(int ka) { return ka * kLdP * sizeof(bf16); }
  // forward: Q, K, V, RA, E, S, P, O, m, l
  // The forward also stages p @ v (D wide) in its score rows.
  static constexpr int kLdF = (D > kT ? D : kT) + 4;
  static size_t fwd(int ka) {
    return 3 * kTile + ra(ka) + e(ka) + kT * kLdF * sizeof(float) + kT * kLdP * sizeof(bf16) +
           kT * (D + 4) * sizeof(float) + 2 * kT * sizeof(float);
  }
  // backward: K, V, Q, dO, RA, E, S, dP, P, dS, lse, delta
  static size_t bwd(int ka) {
    return 4 * kTile + ra(ka) + e(ka) + 2 * kT * kLdS * sizeof(float) +
           2 * kT * kLdP * sizeof(bf16) + 2 * kT * sizeof(float);
  }
};

// Copy rows [r0, r0 + kT) of a (n, D) bf16 matrix into shared rows of
// stride ld; rows past n are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int r0, int n) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kT * (D / 8); i += kRT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        r0 + r < n ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c)
                   : zero;
  }
}

// RA[r][a] = relh[r0 + r][a] for a < h, relw[r0 + r][a - h] for h <= a <
// h + w, 0 past h + w or past n: the query tile's bias features.
__device__ __forceinline__ void load_ra(bf16* ra, int ka, const bf16* relh, const bf16* relw,
                                        int r0, int n, int h, int w) {
  const int ld = ka + 8;
  for (int i = threadIdx.x; i < kT * ka; i += kRT) {
    const int r = i / ka, a = i % ka;
    bf16 val = to_bf(0.f);
    if (r0 + r < n) {
      if (a < h) val = relh[static_cast<size_t>(r0 + r) * h + a];
      else if (a < h + w) val = relw[static_cast<size_t>(r0 + r) * w + a - h];
    }
    ra[r * ld + a] = val;
  }
}

// E[a][c] for the keys k0 + c of the tile: eh[a][key] (a < h), ew[a - h][key]
// (h <= a < h + w), 0 past h + w or past n. Without expanders (B2b) the
// one-hot rows that the indices describe: key / w == a, key % w == a - h.
// Sets bit g of *nz (shared, zeroed by the caller) where rows 16g..16g+15
// hold a non-zero bit pattern: the groups the products cannot skip.
template <bool kExp>
__device__ __forceinline__ void load_e(bf16* e, int ka, const bf16* eh, const bf16* ew, int k0,
                                       int n, int h, int w, int* nz) {
  int bits = 0;
  if (kExp && n % 8 == 0) {  // 16-byte pieces: the expander rows are 16-byte aligned
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < ka * (kT / 8); i += kRT) {
      const int a = i / (kT / 8), c = (i % (kT / 8)) * 8, key = k0 + c;
      uint4 val = zero;
      if (key < n && a < h + w)
        val = *reinterpret_cast<const uint4*>(
            (a < h ? eh + static_cast<size_t>(a) * n : ew + static_cast<size_t>(a - h) * n) +
            key);
      *reinterpret_cast<uint4*>(e + a * kLdP + c) = val;
      if (val.x | val.y | val.z | val.w) bits |= 1 << (a / 16);
    }
  } else {
    for (int i = threadIdx.x; i < ka * kT; i += kRT) {
      const int a = i / kT, c = i % kT, key = k0 + c;
      float val = 0.f;
      if (key < n) {
        if (kExp) {
          if (a < h) val = to_f(eh[static_cast<size_t>(a) * n + key]);
          else if (a < h + w) val = to_f(ew[static_cast<size_t>(a - h) * n + key]);
        } else {
          if (a < h) val = key / w == a ? 1.f : 0.f;
          else if (a < h + w) val = key % w == a - h ? 1.f : 0.f;
        }
      }
      e[a * kLdP + c] = to_bf(val);
      if (val != 0.f) bits |= 1 << (a / 16);
    }
  }
  if (bits) atomicOr(nz, bits);
}

// ------------------------------------------------------------ forward --
template <int D, bool kExp>
__global__ void __launch_bounds__(kRT) rb_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, bf16* __restrict__ o, float* __restrict__ lse, int n, int h,
    int w, int ka) {
  using L = RbSmem<D>;
  constexpr int kLdT = L::kLdT, kLdO = D + 4, kLdS = L::kLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kT * kLdT;
  bf16* Vs = Ks + kT * kLdT;
  bf16* RA = Vs + kT * kLdT;
  bf16* E = RA + kT * (ka + 8);
  float* S = reinterpret_cast<float*>(E + ka * kLdP);
  bf16* P = reinterpret_cast<bf16*>(S + kT * kLdS);
  float* O = reinterpret_cast<float*>(P + kT * kLdP);
  float* m_s = O + kT * kLdO;
  float* l_s = m_s + kT;
  __shared__ int nz[2];  // the expander groups in use, by key-tile parity

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kT, r0 = warp * 16;
  const int lda = ka + 8;
  const bf16* kh = k + bh * n * D;
  const bf16* vh = v + bh * n * D;
  load_rows<D>(Qs, kLdT, q + bh * n * D, q0, n);
  load_ra(RA, ka, relh + bh * n * h, relw + bh * n * w, q0, n, h, w);
  for (int i = threadIdx.x; i < kT * kLdO; i += kRT) O[i] = 0.f;
  if (threadIdx.x < kT) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  if (threadIdx.x < 2) nz[threadIdx.x] = 0;

  for (int k0 = 0; k0 < n; k0 += kT) {
    const int par = (k0 / kT) & 1;
    __syncthreads();  // the previous K, V (and E) tiles and their flags are consumed
    if (threadIdx.x == 0) nz[par ^ 1] = 0;  // the next tile's flags
    load_rows<D>(Ks, kLdT, kh, k0, n);
    load_rows<D>(Vs, kLdT, vh, k0, n);
    if (kExp) load_e<true>(E, ka, eh, ew, k0, n, h, w, &nz[par]);
    __syncthreads();
    const int groups = kExp ? nz[par] : 0;
#pragma unroll
    for (int ct = 0; ct < kT / 16; ++ct) {
      FragC sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Qs + r0 * kLdT + kk, kLdT);
        FragBc fb;  // B[d][key] = K[key][d]
        wmma::load_matrix_sync(fb, Ks + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(sc, fa, fb, sc);
      }
      if (kExp) {  // + [relh | relw] [eh ; ew] over the non-zero groups
        for (int g = 0; g < ka / 16; ++g) {
          if (!(groups >> g & 1)) continue;
          FragA fa;
          wmma::load_matrix_sync(fa, RA + r0 * lda + g * 16, lda);
          FragBr fb;  // B[a][key] = E[a][key]
          wmma::load_matrix_sync(fb, E + g * 16 * kLdP + ct * 16, kLdP);
          wmma::mma_sync(sc, fa, fb, sc);
        }
      }
      wmma::store_matrix_sync(S + r0 * kLdS + ct * 16, sc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, key = k0 + c;
        s[j] = S[r * kLdS + c];
        if (!kExp && key < n) {  // (q.k + relw) + relh, as the TPU kernel sums them
          const int g = key / w;
          s[j] = (s[j] + to_f(RA[r * lda + h + key - g * w])) + to_f(RA[r * lda + g]);
        }
        if (key >= n) s[j] = kNegInf;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      P[r * kLdP + lane] = to_bf(p0);
      P[r * kLdP + lane + 32] = to_bf(p1);
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      for (int c = lane; c < D; c += 32) O[r * kLdO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncwarp();
    // p @ v for the warp's rows, staged in its (now free) score rows.
#pragma unroll
    for (int ct = 0; ct < D / 16; ++ct) {
      FragC oc;
      wmma::fill_fragment(oc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        FragA pa;
        wmma::load_matrix_sync(pa, P + r0 * kLdP + kk, kLdP);
        FragBr vb;  // B[key][c] = V[key][c]
        wmma::load_matrix_sync(vb, Vs + kk * kLdT + ct * 16, kLdT);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(S + r0 * kLdS + ct * 16, oc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = r0 + e / D, c = e % D;
      O[r * kLdO + c] += S[r * kLdS + c];
    }
    __syncwarp();
  }
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = r0 + e / D, c = e % D;
    if (q0 + r < n) o[(bh * n + q0 + r) * D + c] = to_bf(O[r * kLdO + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (lane < 16 && q0 + r0 + lane < n) {
    const int r = r0 + lane;
    lse[bh * n + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] in fp32: one warp a row.
template <int D>
__global__ void rb_delta_kernel(const bf16* __restrict__ d_o, const bf16* __restrict__ o,
                                float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(d_o[base + c]) * to_f(o[base + c]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ----------------------------------------------------------- backward --
template <int D, bool kExp>
__global__ void __launch_bounds__(kRT) rb_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_acc, float* __restrict__ drel_acc,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int h, int w, int ka) {
  using L = RbSmem<D>;
  constexpr int kLdT = L::kLdT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kT * kLdT;
  bf16* Qs = Vs + kT * kLdT;
  bf16* dOs = Qs + kT * kLdT;
  bf16* RA = dOs + kT * kLdT;
  bf16* E = RA + kT * (ka + 8);
  float* S = reinterpret_cast<float*>(E + ka * kLdP);  // [query][key]
  float* dP = S + kT * kLdS;
  bf16* Pb = reinterpret_cast<bf16*>(dP + kT * kLdS);
  bf16* dSb = Pb + kT * kLdP;
  float* lse_s = reinterpret_cast<float*>(dSb + kT * kLdP);
  float* del_s = lse_s + kT;
  __shared__ int nz;  // the expander groups of this key tile in use

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kT, r0 = warp * 16;
  const int lda = ka + 8, hw = h + w;
  const bf16* qh = q + bh * n * D;
  const bf16* doh = d_o + bh * n * D;
  if (threadIdx.x == 0) nz = 0;
  __syncthreads();
  load_rows<D>(Ks, kLdT, k + bh * n * D, k0, n);
  load_rows<D>(Vs, kLdT, v + bh * n * D, k0, n);
  load_e<kExp>(E, ka, eh, ew, k0, n, h, w, &nz);
  __syncthreads();
  const int groups = nz;

  FragC acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    wmma::fill_fragment(acc_k[t], 0.f);
    wmma::fill_fragment(acc_v[t], 0.f);
  }
  const int tiles = (n + kT - 1) / kT;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = ((blockIdx.x + it) % tiles) * kT;  // staggered over the blocks
    __syncthreads();  // the previous query tile is consumed
    load_rows<D>(Qs, kLdT, qh, q0, n);
    load_rows<D>(dOs, kLdT, doh, q0, n);
    load_ra(RA, ka, relh + bh * n * h, relw + bh * n * w, q0, n, h, w);
    if (threadIdx.x < kT) {
      const bool in = q0 + threadIdx.x < n;  // past n: p = exp(-inf) = 0
      lse_s[threadIdx.x] = in ? lse[bh * n + q0 + threadIdx.x] : INFINITY;
      del_s[threadIdx.x] = in ? delta[bh * n + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // Warp w: the score and dp rows of queries r0.. against this key tile.
#pragma unroll
    for (int ct = 0; ct < kT / 16; ++ct) {
      FragC sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        FragA fa;
        FragBc fb;  // B[d][key] = K[key][d]
        wmma::load_matrix_sync(fa, Qs + r0 * kLdT + kk, kLdT);
        wmma::load_matrix_sync(fb, Ks + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(sc, fa, fb, sc);
        wmma::load_matrix_sync(fa, dOs + r0 * kLdT + kk, kLdT);
        wmma::load_matrix_sync(fb, Vs + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(dc, fa, fb, dc);
      }
      if (kExp) {
        for (int g = 0; g < ka / 16; ++g) {
          if (!(groups >> g & 1)) continue;
          FragA fa;
          wmma::load_matrix_sync(fa, RA + r0 * lda + g * 16, lda);
          FragBr fb;  // B[a][key] = E[a][key]
          wmma::load_matrix_sync(fb, E + g * 16 * kLdP + ct * 16, kLdP);
          wmma::mma_sync(sc, fa, fb, sc);
        }
      }
      wmma::store_matrix_sync(S + r0 * kLdS + ct * 16, sc, kLdS, wmma::mem_row_major);
      wmma::store_matrix_sync(dP + r0 * kLdS + ct * 16, dc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * kT; e += 32) {
      const int r = r0 + e / kT, c = e % kT, key = k0 + c;
      float s = S[r * kLdS + c];
      if (!kExp && key < n) {
        const int g = key / w;
        s = (s + to_f(RA[r * lda + h + key - g * w])) + to_f(RA[r * lda + g]);
      }
      const float p = key < n ? expf(s - lse_s[r]) : 0.f;
      Pb[r * kLdP + c] = to_bf(p);
      dSb[r * kLdP + c] = to_bf(p * (dP[r * kLdS + c] - del_s[r]));
    }
    __syncthreads();  // dk and dv below read every query row
    // Warp w owns keys r0..r0+15: dv += p^T do, dk += ds^T q.
    using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      FragACol pa, da;  // A[key][query] = P[query][key]
      wmma::load_matrix_sync(pa, Pb + kk * kLdP + r0, kLdP);
      wmma::load_matrix_sync(da, dSb + kk * kLdP + r0, kLdP);
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        FragBr ob;  // B[query][c] = dO[query][c]
        wmma::load_matrix_sync(ob, dOs + kk * kLdT + t * 16, kLdT);
        wmma::mma_sync(acc_v[t], pa, ob, acc_v[t]);
        FragBr qb;  // B[query][d] = Q[query][d]
        wmma::load_matrix_sync(qb, Qs + kk * kLdT + t * 16, kLdT);
        wmma::mma_sync(acc_k[t], da, qb, acc_k[t]);
      }
    }
    // Warp w's query rows: [dq | drelh | drelw] += ds [k | e^T], added to
    // the fp32 accumulators a 16 x 16 tile at a time through its (free)
    // score rows.
    float* st = S + r0 * kLdS;
    for (int t = 0; t < D / 16 + ka / 16; ++t) {
      const bool is_q = t < D / 16;
      const int g = t - D / 16;
      if (!is_q && !(groups >> g & 1)) continue;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        FragA da;
        wmma::load_matrix_sync(da, dSb + r0 * kLdP + kk, kLdP);
        if (is_q) {
          FragBr kb;  // B[key][d] = K[key][d]
          wmma::load_matrix_sync(kb, Ks + kk * kLdT + t * 16, kLdT);
          wmma::mma_sync(acc, da, kb, acc);
        } else {
          FragBc eb;  // B[key][a] = E[a][key]
          wmma::load_matrix_sync(eb, E + g * 16 * kLdP + kk, kLdP);
          wmma::mma_sync(acc, da, eb, acc);
        }
      }
      __syncwarp();
      wmma::store_matrix_sync(st, acc, kLdS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16, row = q0 + r0 + r;
        if (row >= n) continue;
        if (is_q) {
          atomicAdd(dq_acc + (bh * n + row) * D + t * 16 + c, st[r * kLdS + c]);
        } else if (g * 16 + c < hw) {
          atomicAdd(drel_acc + (bh * n + row) * hw + g * 16 + c, st[r * kLdS + c]);
        }
      }
    }
  }
  __syncthreads();  // S is free for staging
  float* st = S + r0 * kLdS;
#pragma unroll
  for (int t = 0; t < 2 * (D / 16); ++t) {
    const bool is_k = t < D / 16;
    const int u = is_k ? t : t - D / 16;
    wmma::store_matrix_sync(st, is_k ? acc_k[u] : acc_v[u], kLdS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      if (k0 + r0 + r >= n) continue;
      const size_t row = bh * n + k0 + r0 + r;
      (is_k ? dk : dv)[row * D + u * 16 + c] = to_bf(st[r * kLdS + c]);
    }
    __syncwarp();
  }
}

constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D, bool kExp>
int rb_forward(const void* q, const void* k, const void* v, const void* relh, const void* relw,
               const void* eh, const void* ew, void* o, void* lse, int bh, int n, int h, int w,
               void* stream) {
  const int ka = (h + w + 15) / 16 * 16;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = RbSmem<D>::fwd(ka);
  if (int err = set_smem(rb_fwd_kernel<D, kExp>, smem)) return err;
  rb_fwd_kernel<D, kExp><<<dim3((n + kT - 1) / kT, bh), kRT, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(relh), static_cast<const bf16*>(relw),
      static_cast<const bf16*>(eh), static_cast<const bf16*>(ew), static_cast<bf16*>(o),
      static_cast<float*>(lse), n, h, w, ka);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kExp>
int rb_backward(const void* q, const void* k, const void* v, const void* relh, const void* relw,
                const void* eh, const void* ew, const void* o, const void* lse, const void* d_o,
                void* delta, void* dq_acc, void* drel_acc, void* dk, void* dv, int bh, int n,
                int h, int w, void* stream) {
  const int ka = (h + w + 15) / 16 * 16;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n;
  rb_delta_kernel<D><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(d_o),
                                                     static_cast<const bf16*>(o),
                                                     static_cast<float*>(delta), rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const size_t smem = RbSmem<D>::bwd(ka);
  if (int err = set_smem(rb_bwd_kernel<D, kExp>, smem)) return err;
  rb_bwd_kernel<D, kExp><<<dim3((n + kT - 1) / kT, bh), kRT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(relh), static_cast<const bf16*>(relw),
      static_cast<const bf16*>(eh), static_cast<const bf16*>(ew), static_cast<const bf16*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<float*>(drel_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, h, w, ka);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q (pre-scaled), k, v, o: (BH, N, d) bf16 with d 64 or 80; relh (BH, N, h),
// relw (BH, N, w) bf16; lse (BH, N) fp32. B2b: bias relh[., key / w] +
// relw[., key % w]. B14: eh (h, N) and ew (w, N) bf16 expanders.
#define IUVL_RB_DISPATCH(fn, exp, ...)                               \
  switch (d) {                                                      \
    case 64: return fn<64, exp>(__VA_ARGS__);                       \
    case 80: return fn<80, exp>(__VA_ARGS__);                       \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

extern "C" int iuvl_rowbias_fwd(const void* q, const void* k, const void* v, const void* relh,
                                const void* relw, void* o, void* lse, int bh, int n, int d,
                                int h, int w, void* stream) {
  if (h * w != n) return static_cast<int>(cudaErrorInvalidValue);
  IUVL_RB_DISPATCH(rb_forward, false, q, k, v, relh, relw, nullptr, nullptr, o, lse, bh, n, h,
                   w, stream)
}

extern "C" int iuvl_relpos_fwd(const void* q, const void* k, const void* v, const void* relh,
                               const void* relw, const void* eh, const void* ew, void* o,
                               void* lse, int bh, int n, int d, int h, int w, void* stream) {
  IUVL_RB_DISPATCH(rb_forward, true, q, k, v, relh, relw, eh, ew, o, lse, bh, n, h, w, stream)
}

// The backward: o and lse from the forward, do (BH, N, d) bf16; delta (BH,
// N) fp32 scratch; dq_acc (BH, N, d) and drel_acc (BH, N, h + w) fp32,
// zeroed by the caller, receive dq and [drelh | drelw]; dk, dv (BH, N, d)
// bf16.
extern "C" int iuvl_rowbias_bwd(const void* q, const void* k, const void* v, const void* relh,
                                const void* relw, const void* o, const void* lse,
                                const void* d_o, void* delta, void* dq_acc, void* drel_acc,
                                void* dk, void* dv, int bh, int n, int d, int h, int w,
                                void* stream) {
  if (h * w != n) return static_cast<int>(cudaErrorInvalidValue);
  IUVL_RB_DISPATCH(rb_backward, false, q, k, v, relh, relw, nullptr, nullptr, o, lse, d_o,
                   delta, dq_acc, drel_acc, dk, dv, bh, n, h, w, stream)
}

extern "C" int iuvl_relpos_bwd(const void* q, const void* k, const void* v, const void* relh,
                               const void* relw, const void* eh, const void* ew, const void* o,
                               const void* lse, const void* d_o, void* delta, void* dq_acc,
                               void* drel_acc, void* dk, void* dv, int bh, int n, int d, int h,
                               int w, void* stream) {
  IUVL_RB_DISPATCH(rb_backward, true, q, k, v, relh, relw, eh, ew, o, lse, d_o, delta, dq_acc,
                   drel_acc, dk, dv, bh, n, h, w, stream)
}
