// Flash attention for training (B11): the forward stores the per-row
// logsumexp; the backward recomputes the probabilities from it in two
// passes (dq over query tiles; dk and dv over key tiles).
//   o = softmax(q k^T) v,  lse = logsumexp(q k^T)   (scale folded into q)
//   dq = ds k, dk = ds^T q, dv = p^T do,  ds = p (do v^T - rowsum(do o))
// Replaces iuvl_tpu/ops/pallas/flash_attention.py:flash_attention
// (_flash_forward with lse, _flash_backward's dq and dk/dv kernels). The
// SAM global blocks call it on rel-pos-augmented q, k (d_qk 192 = 64 +
// 64 + 64) and v (d_v 64): 12 heads x 4096 tokens at 1024^2.
//
// Bound on the card: operations. The function needs 2 N^2 (d_qk + d_v)
// per head for the forward (103 GFLOP at the slice's shape) and
// 2 N^2 (3 d_qk + 2 d_v) for the backward (s once from lse, then dp, dq,
// dk, dv: 283 GFLOP), 0.39 ms at 989 TFLOP/s. The two backward passes
// here each recompute s and dp, 2 N^2 (4 d_qk + 3 d_v) (386 GFLOP, 36%
// over the function's need): the price of keeping dq and dk/dv as plain
// register sums instead of atomics. The N x N scores must never reach
// device memory. The TPU grid walked
// (head, q block, k block) in order with VMEM accumulators; here one block
// of four warps owns a 64-row tile and loops over the other side's 64-row
// tiles, each warp a 16-row strip. The forward keeps its running output
// in shared memory (fp32, rescaled per row by the online-softmax alpha);
// the dq pass keeps dq and the dk/dv pass keeps dk and dv as register
// accumulators, since those only ever add. The TPU padded d_qk 192 to 256
// lanes; here 192 is 12 tensor-core k-steps as it is.
//
// Rounding points follow the TPU kernels: s and the softmax in fp32; the
// unnormalised p = exp(s - m) rounded to bf16 for p @ v; o = bf16(acc / l);
// lse = m + log(l); in the backward p = exp(s - lse) in fp32, ds in fp32
// rounded to bf16 before both products, dv from bf16(p); dq, dk, dv are
// fp32 sums rounded once. delta = rowsum(do * o) is a small pass of its
// own, as the TPU left it to XLA.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kFT = 128;   // threads: 4 warps, each a 16-row strip
constexpr int kB = 64;     // query / key tile
constexpr int kDV = 64;    // v head dim
constexpr int kLdV = kDV + 8;
constexpr int kLdS = kB + 4;   // fp32 score rows
constexpr int kLdP = kB + 8;   // bf16 probability rows

template <int DQK>
struct FlashSmem {
  static constexpr int kLdQ = DQK + 8;
  static constexpr size_t kQ = kB * kLdQ * sizeof(bf16);
  static constexpr size_t kV = kB * kLdV * sizeof(bf16);
  static constexpr size_t kS = kB * kLdS * sizeof(float);
  static constexpr size_t kP = kB * kLdP * sizeof(bf16);
  // forward: Q, K, V, S, P, O (fp32, kDV + 4 wide), m, l
  static constexpr size_t kFwd = 2 * kQ + kV + kS + kP + kB * (kDV + 4) * sizeof(float) +
                                 2 * kB * sizeof(float);
  // backward: Q, K, V, dO, S, dP, P, dS, lse, delta
  static constexpr size_t kBwd = 2 * kQ + 2 * kV + 2 * kS + 2 * kP + 2 * kB * sizeof(float);
};

// Copy a (kB, width) bf16 tile with row stride `ld_g` into shared rows of `ld_s`.
template <int WIDTH>
__device__ __forceinline__ void load_tile(bf16* dst, int ld_s, const bf16* src, int ld_g) {
  for (int i = threadIdx.x; i < kB * (WIDTH / 8); i += kFT) {
    const int r = i / (WIDTH / 8), v = (i % (WIDTH / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld_s + v) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * ld_g + v);
  }
}

template <int DQK>
__global__ void __launch_bounds__(kFT) flash_fwd_kernel(const bf16* __restrict__ q,
                                                        const bf16* __restrict__ k,
                                                        const bf16* __restrict__ v,
                                                        bf16* __restrict__ o,
                                                        float* __restrict__ lse, int n) {
  using L = FlashSmem<DQK>;
  constexpr int kLdQ = L::kLdQ, kLdO = kDV + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * L::kQ);
  float* S = reinterpret_cast<float*>(smem + 2 * L::kQ + L::kV);
  bf16* P = reinterpret_cast<bf16*>(smem + 2 * L::kQ + L::kV + L::kS);
  float* O = reinterpret_cast<float*>(smem + 2 * L::kQ + L::kV + L::kS + L::kP);
  float* m_s = O + kB * kLdO;
  float* l_s = m_s + kB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const bf16* qh = q + (bh * n + q0) * DQK;
  const bf16* kh = k + bh * n * DQK;
  const bf16* vh = v + bh * n * kDV;
  load_tile<DQK>(Qs, kLdQ, qh, DQK);
  for (int i = threadIdx.x; i < kB * kLdO; i += kFT) O[i] = 0.f;
  if (threadIdx.x < kB) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  const int r0 = warp * 16;  // this warp's 16 query rows

  for (int kt = 0; kt < n / kB; ++kt) {
    __syncthreads();  // the previous K, V tiles are consumed
    load_tile<DQK>(Ks, kLdQ, kh + static_cast<size_t>(kt) * kB * DQK, DQK);
    load_tile<kDV>(Vs, kLdV, vh + static_cast<size_t>(kt) * kB * kDV, kDV);
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < kB / 16; ++ct) {
      FragC sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DQK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Qs + r0 * kLdQ + kk, kLdQ);
        FragBc fb;  // B[d][key] = K[key][d]
        wmma::load_matrix_sync(fb, Ks + ct * 16 * kLdQ + kk, kLdQ);
        wmma::mma_sync(sc, fa, fb, sc);
      }
      wmma::store_matrix_sync(S + r0 * kLdS + ct * 16, sc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float s0 = S[r * kLdS + lane], s1 = S[r * kLdS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      P[r * kLdP + lane] = to_bf(p0);
      P[r * kLdP + lane + 32] = to_bf(p1);
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      O[r * kLdO + lane] *= alpha;
      O[r * kLdO + lane + 32] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncwarp();
    // p @ v for the warp's rows, staged in its (now free) score rows.
#pragma unroll
    for (int ct = 0; ct < kDV / 16; ++ct) {
      FragC oc;
      wmma::fill_fragment(oc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kB; kk += 16) {
        FragA pa;
        wmma::load_matrix_sync(pa, P + r0 * kLdP + kk, kLdP);
        FragBr vb;  // B[key][c] = V[key][c]
        wmma::load_matrix_sync(vb, Vs + kk * kLdV + ct * 16, kLdV);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(S + r0 * kLdS + ct * 16, oc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 16 * kDV; e += 32) {
      const int r = r0 + e / kDV, c = e % kDV;
      O[r * kLdO + c] += S[r * kLdS + c];
    }
    __syncwarp();
  }
  for (int e = lane; e < 16 * kDV; e += 32) {
    const int r = r0 + e / kDV, c = e % kDV;
    o[(bh * n + q0 + r) * kDV + c] = to_bf(O[r * kLdO + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (lane < 16) {
    const int r = r0 + lane;
    lse[bh * n + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

// delta[row] = sum_c do[row, c] * o[row, c] in fp32: one warp a row.
__global__ void flash_delta_kernel(const bf16* __restrict__ d_o, const bf16* __restrict__ o,
                                   float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * kDV;
  float s = to_f(d_o[base + lane]) * to_f(o[base + lane]) +
            to_f(d_o[base + lane + 32]) * to_f(o[base + lane + 32]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// S (rows r0.., 64 cols) = A_rows (16 x D) . B^T for B rows [0, 64): four
// column tiles of one warp, stored to S with row stride kLdS.
template <int D, int LDA, int LDB>
__device__ __forceinline__ void strip_nt(const bf16* a, const bf16* b, float* s) {
#pragma unroll
  for (int ct = 0; ct < kB / 16; ++ct) {
    FragC sc;
    wmma::fill_fragment(sc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + kk, LDA);
      FragBc fb;
      wmma::load_matrix_sync(fb, b + ct * 16 * LDB + kk, LDB);
      wmma::mma_sync(sc, fa, fb, sc);
    }
    wmma::store_matrix_sync(s + ct * 16, sc, kLdS, wmma::mem_row_major);
  }
}

template <int DQK>
__global__ void __launch_bounds__(kFT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int n) {
  using L = FlashSmem<DQK>;
  constexpr int kLdQ = L::kLdQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kB * kLdQ;
  bf16* Vs = Ks + kB * kLdQ;
  bf16* dOs = Vs + kB * kLdV;
  float* S = reinterpret_cast<float*>(dOs + kB * kLdV);
  float* dP = S + kB * kLdS;
  bf16* dSb = reinterpret_cast<bf16*>(dP + kB * kLdS);
  float* lse_s = reinterpret_cast<float*>(dSb + 2 * kB * kLdP);
  float* del_s = lse_s + kB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kB, r0 = warp * 16;
  load_tile<DQK>(Qs, kLdQ, q + (bh * n + q0) * DQK, DQK);
  load_tile<kDV>(dOs, kLdV, d_o + (bh * n + q0) * kDV, kDV);
  if (threadIdx.x < kB) {
    lse_s[threadIdx.x] = lse[bh * n + q0 + threadIdx.x];
    del_s[threadIdx.x] = delta[bh * n + q0 + threadIdx.x];
  }
  FragC acc[DQK / 16];
#pragma unroll
  for (int t = 0; t < DQK / 16; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int kt = 0; kt < n / kB; ++kt) {
    __syncthreads();
    load_tile<DQK>(Ks, kLdQ, k + (bh * n + static_cast<size_t>(kt) * kB) * DQK, DQK);
    load_tile<kDV>(Vs, kLdV, v + (bh * n + static_cast<size_t>(kt) * kB) * kDV, kDV);
    __syncthreads();
    strip_nt<DQK, kLdQ, kLdQ>(Qs + r0 * kLdQ, Ks, S + r0 * kLdS);
    strip_nt<kDV, kLdV, kLdV>(dOs + r0 * kLdV, Vs, dP + r0 * kLdS);
    __syncwarp();
    for (int e = lane; e < 16 * kB; e += 32) {
      const int r = r0 + e / kB, c = e % kB;
      const float p = expf(S[r * kLdS + c] - lse_s[r]);
      dSb[r * kLdP + c] = to_bf(p * (dP[r * kLdS + c] - del_s[r]));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      FragA da;
      wmma::load_matrix_sync(da, dSb + r0 * kLdP + kk, kLdP);
#pragma unroll
      for (int t = 0; t < DQK / 16; ++t) {
        FragBr kb;  // B[key][d] = K[key][d]
        wmma::load_matrix_sync(kb, Ks + kk * kLdQ + t * 16, kLdQ);
        wmma::mma_sync(acc[t], da, kb, acc[t]);
      }
    }
  }
  float* st = S + r0 * kLdS;  // this warp's rows, free now
#pragma unroll
  for (int t = 0; t < DQK / 16; ++t) {
    __syncwarp();
    wmma::store_matrix_sync(st, acc[t], kLdS, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      dq[(bh * n + q0 + r0 + r) * DQK + t * 16 + c] = to_bf(st[r * kLdS + c]);
    }
  }
}

template <int DQK>
__global__ void __launch_bounds__(kFT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n) {
  using L = FlashSmem<DQK>;
  constexpr int kLdQ = L::kLdQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Qs = Ks + kB * kLdQ;
  bf16* Vs = Qs + kB * kLdQ;
  bf16* dOs = Vs + kB * kLdV;
  float* S = reinterpret_cast<float*>(dOs + kB * kLdV);  // [query][key]
  float* dP = S + kB * kLdS;
  bf16* Pb = reinterpret_cast<bf16*>(dP + kB * kLdS);
  bf16* dSb = Pb + kB * kLdP;
  float* lse_s = reinterpret_cast<float*>(dSb + kB * kLdP);
  float* del_s = lse_s + kB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kB, r0 = warp * 16;
  load_tile<DQK>(Ks, kLdQ, k + (bh * n + k0) * DQK, DQK);
  load_tile<kDV>(Vs, kLdV, v + (bh * n + k0) * kDV, kDV);
  FragC acc_k[DQK / 16], acc_v[kDV / 16];
#pragma unroll
  for (int t = 0; t < DQK / 16; ++t) wmma::fill_fragment(acc_k[t], 0.f);
#pragma unroll
  for (int t = 0; t < kDV / 16; ++t) wmma::fill_fragment(acc_v[t], 0.f);

  for (int qt = 0; qt < n / kB; ++qt) {
    __syncthreads();
    const size_t row0 = bh * n + static_cast<size_t>(qt) * kB;
    load_tile<DQK>(Qs, kLdQ, q + row0 * DQK, DQK);
    load_tile<kDV>(dOs, kLdV, d_o + row0 * kDV, kDV);
    if (threadIdx.x < kB) {
      lse_s[threadIdx.x] = lse[row0 + threadIdx.x];
      del_s[threadIdx.x] = delta[row0 + threadIdx.x];
    }
    __syncthreads();
    // Warp w: the score and dP rows of queries r0.. against this key tile.
    strip_nt<DQK, kLdQ, kLdQ>(Qs + r0 * kLdQ, Ks, S + r0 * kLdS);
    strip_nt<kDV, kLdV, kLdV>(dOs + r0 * kLdV, Vs, dP + r0 * kLdS);
    __syncwarp();
    for (int e = lane; e < 16 * kB; e += 32) {
      const int r = r0 + e / kB, c = e % kB;
      const float p = expf(S[r * kLdS + c] - lse_s[r]);
      Pb[r * kLdP + c] = to_bf(p);
      dSb[r * kLdP + c] = to_bf(p * (dP[r * kLdS + c] - del_s[r]));
    }
    __syncthreads();  // products below read every query row
    // Warp w owns keys r0..r0+15: dv += p^T do, dk += ds^T q.
    using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
#pragma unroll
    for (int kk = 0; kk < kB; kk += 16) {
      FragACol pa, da;  // A[key][query] = P[query][key]
      wmma::load_matrix_sync(pa, Pb + kk * kLdP + r0, kLdP);
      wmma::load_matrix_sync(da, dSb + kk * kLdP + r0, kLdP);
#pragma unroll
      for (int t = 0; t < kDV / 16; ++t) {
        FragBr ob;  // B[query][c] = dO[query][c]
        wmma::load_matrix_sync(ob, dOs + kk * kLdV + t * 16, kLdV);
        wmma::mma_sync(acc_v[t], pa, ob, acc_v[t]);
      }
#pragma unroll
      for (int t = 0; t < DQK / 16; ++t) {
        FragBr qb;  // B[query][d] = Q[query][d]
        wmma::load_matrix_sync(qb, Qs + kk * kLdQ + t * 16, kLdQ);
        wmma::mma_sync(acc_k[t], da, qb, acc_k[t]);
      }
    }
  }
  __syncthreads();  // S is free for staging
  float* st = S + r0 * kLdS;
#pragma unroll
  for (int t = 0; t < DQK / 16 + kDV / 16; ++t) {
    const bool is_k = t < DQK / 16;
    wmma::store_matrix_sync(st, is_k ? acc_k[t] : acc_v[t - DQK / 16], kLdS,
                            wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      const size_t row = bh * n + k0 + r0 + r;
      if (is_k)
        dk[row * DQK + t * 16 + c] = to_bf(st[r * kLdS + c]);
      else
        dv[row * kDV + (t - DQK / 16) * 16 + c] = to_bf(st[r * kLdS + c]);
    }
    __syncwarp();
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

constexpr int kDQK = 192;  // the augmented SAM head: 64 + 64 + 64

// q, k: (BH, N, 192) bf16; v, o: (BH, N, 64) bf16; lse: (BH, N) fp32.
// N % 64 == 0; the softmax scale is folded into q by the caller.
extern "C" int iuvl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d_qk, int d_v, void* stream) {
  if (d_qk != kDQK || d_v != kDV || n % kB) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FlashSmem<kDQK>::kFwd;
  if (int err = set_smem(flash_fwd_kernel<kDQK>, smem)) return err;
  flash_fwd_kernel<kDQK><<<dim3(n / kB, bh), kFT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n);
  return static_cast<int>(cudaGetLastError());
}

// The backward of iuvl_flash_fwd: do (BH, N, 64) bf16, o and lse from the
// forward; delta (BH, N) fp32 scratch; dq, dk (BH, N, 192) and dv
// (BH, N, 64) bf16.
extern "C" int iuvl_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* d_o, void* delta, void* dq, void* dk,
                              void* dv, int bh, int n, int d_qk, int d_v, void* stream) {
  if (d_qk != kDQK || d_v != kDV || n % kB) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n;
  flash_delta_kernel<<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(d_o),
                                                    static_cast<const bf16*>(o),
                                                    static_cast<float*>(delta), rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const size_t smem = FlashSmem<kDQK>::kBwd;
  if (int err = set_smem(flash_bwd_dq_kernel<kDQK>, smem)) return err;
  flash_bwd_dq_kernel<kDQK><<<dim3(n / kB, bh), kFT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = set_smem(flash_bwd_dkv_kernel<kDQK>, smem)) return err;
  flash_bwd_dkv_kernel<kDQK><<<dim3(n / kB, bh), kFT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n);
  return static_cast<int>(cudaGetLastError());
}
