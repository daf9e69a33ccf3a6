// Register-level tensor-core helpers for the attention kernels that keep
// their scores in registers (B13 window_attention.cu, the B2b / B14
// forward and backward in flash_attention_rowbias.cu and rowbias_fwd.cuh,
// B11's in flash_attention_train.cu, B1's in window_block.cu), and the
// online softmax of a 64-key tile that the forwards share.
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) with its fragments loaded
// by ldmatrix from padded shared-memory rows. In a warp, lane t holds:
// - of a 16 x 8 fp32 accumulator c[4]: rows t/4 (c[0], c[1]) and t/4 + 8
//   (c[2], c[3]), columns 2 (t % 4) and 2 (t % 4) + 1;
// - of a 16 x 16 A operand a[4]: the same rows, columns 2 (t % 4) + {0, 1}
//   (a[0], a[1]) and those + 8 (a[2], a[3]), two bf16 to a register;
// - of a 16 x 8 B operand b[2]: rows (depth) 2 (t % 4) + {0, 1} (b[0]) and
//   those + 8 (b[1]), column t / 4.
// So two accumulator tiles side by side are, packed to bf16, the A operand
// of the next product (scores -> probabilities -> p v) without leaving
// registers. The shared-memory rows are padded to a pitch of 8 bf16 past a
// multiple of 64, so the eight 16-byte rows of one ldmatrix phase fall in
// distinct banks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace iuvl {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b (m16n8k16, bf16 operands, fp32 accumulators).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx.ftz: about 2 ulp, results below 2^-126 flushed
// to 0), without exp2f's extra instructions for subnormal results.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [m0, m0 + 16) and depth [k0, k0 + 16) of a
// row-major (m, k) shared tile of pitch ld (elements).
__device__ __forceinline__ void lda_rows(uint32_t (&a)[4], const bf16* base, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, base + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}

// The A fragment of A[m][k] = T[k][m], T a row-major (k, m) shared tile.
__device__ __forceinline__ void lda_cols(uint32_t (&a)[4], const bf16* base, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm_x4_t(a, base + (k0 + (l & 7) + (i >> 1) * 8) * ld + m0 + (i & 1) * 8);
}

// B fragments of two 8-column tiles [n0, n0 + 16) at depth [k0, k0 + 16)
// with B[k][n] = T[n][k], T a row-major (n, k) shared tile (K for q k^T):
// b[0], b[1] for columns n0.., b[2], b[3] for n0 + 8...
__device__ __forceinline__ void ldb_rows(uint32_t (&b)[4], const bf16* base, int ld, int n0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, base + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
}

// The same with B[k][n] = T[k][n], T a row-major (k, n) shared tile (V for
// p v).
__device__ __forceinline__ void ldb_cols(uint32_t (&b)[4], const bf16* base, int ld, int n0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, base + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

// The A fragment for depth chunk j (columns 16 j .. 16 j + 15) of a strip
// of accumulator tiles acc[2 j], acc[2 j + 1], rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// s[j] = q k^T for a warp's 16-row strip (A fragments qf) against keys
// [16 p, 16 p + 16) of the key tile Kt (pitch ld), p < pairs (a full tile
// has 4 pairs); s[2 p .. 2 p + 1] of the pairs past stay 0.
template <int D>
__device__ __forceinline__ void strip_scores(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                             const bf16* Kt, int ld, int pairs) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (p >= pairs) break;
      uint32_t b[4];
      ldb_rows(b, Kt, ld, p * 16, kk * 16);
      mma16816(s[2 * p], qf[kk], b[0], b[1]);
      mma16816(s[2 * p + 1], qf[kk], b[2], b[3]);
    }
  }
}

// 16-byte cp.async that writes zeros (reads nothing) when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Rows [r0, r0 + rows) of a (n, D) bf16 matrix into shared rows of pitch
// ld by cp.async, rows past n zero; `threads` threads from `tid`.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, int ld, const bf16* src, int r0, int rows, int n,
                                        int tid, int threads) {
  for (int i = tid; i < rows * (D / 8); i += threads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool in = r0 + r < n;
    cp_async16_zfill(dst + r * ld + c, src + static_cast<size_t>(in ? r0 + r : 0) * D + c, in);
  }
}

// A warp's 16-row strip of fp32 accumulators x[D / 8][4] (rows row0 ..
// row0 + 15 of an (n, D) bf16 matrix at out, rows ld apart), rounded to
// bf16; rows past n dropped.
template <int D>
__device__ __forceinline__ void store_strip_rows(bf16* out, const float (&x)[D / 8][4], int row0,
                                                 int n, int ld = D) {
  const int lane = threadIdx.x & 31, lo = row0 + (lane >> 2), hi = lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    if (lo < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(lo) * ld + c) =
          pack_bf16(x[j][0], x[j][1]);
    if (hi < n)
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(hi) * ld + c) =
          pack_bf16(x[j][2], x[j][3]);
  }
}

// s = -inf for the keys past n (the masked last tile).
__device__ __forceinline__ void mask_past(float (&s)[8][4], int k0, int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (k0 + 8 * j + 2 * (lane & 3) + e >= n) s[j][e] = s[j][e + 2] = kNegInf;
}

// One 64-key tile of the online softmax for the lane's two rows: m, l and
// the output sums rescaled by alpha = exp(m_old - m_new), s replaced by the
// unnormalised p = exp(s - m_new) in fp32 (l sums it so; p v rounds it);
// the exponentials by ex2.approx, or by expf where kExact. kRows 1: the
// first row only (the strip's rows 8-15 are padding; their s, m, l and o
// are left as they are).
template <int D, bool kExact = false, int kRows = 2>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[D / 8][4]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * u], s[j][2 * u + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[u], mx), ml = m_new * kLog2e;
    const float alpha = kExact ? expf(m[u] - m_new) : ex2((m[u] - m_new) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * u; e < 2 * u + 2; ++e) {
        s[j][e] = kExact ? expf(s[j][e] - m_new) : ex2(fmaf(s[j][e], kLog2e, -ml));
        sum += s[j][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[u] = l[u] * alpha + sum;
    m[u] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * u] *= alpha;
      o[j][2 * u + 1] *= alpha;
    }
  }
}

// o += bf16(p) v over keys [16 p, 16 p + 16) of the key tile Vt (pitch ld),
// p < pairs: p packed straight into the A operand.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[8][4],
                                        const bf16* Vt, int ld, int pairs) {
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) {
    if (kp >= pairs) break;
    uint32_t a[4];
    acc_to_a(a, p[2 * kp], p[2 * kp + 1]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldb_cols(b, Vt, ld, dn * 16, kp * 16);  // B[key][c] = V[key][c]
      mma16816(o[2 * dn], a, b[0], b[1]);
      mma16816(o[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// o = bf16(acc / l) and lse = m + log l for the strip's rows row0 .. row0 +
// 15 of one (batch, head); rows past n dropped.
template <int D>
__device__ __forceinline__ void store_fwd(bf16* o, float* lse, float (&acc)[D / 8][4],
                                          const float (&m)[2], const float (&l)[2], int row0,
                                          int n) {
  const int lane = threadIdx.x & 31;
  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] / lc[e >> 1];
  store_strip_rows<D>(o, acc, row0, n);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = row0 + (lane >> 2) + 8 * u;
      if (row < n) lse[row] = m[u] + logf(lc[u]);
    }
  }
}

}  // namespace
}  // namespace iuvl
