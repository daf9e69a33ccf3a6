// The decomposed rel-pos features of a 14 x 14 window on the tensor cores,
// shared by B1's forward (window_block.cu) and B9's backward
// (window_block_bwd.cu), so that the backward recomputes the forward's
// bits: relh[i, a] = bf16(q_i . Rh[i / 14, a]) and relw[i, a] = bf16(q_i .
// Rw[i % 14, a]) with fp32 sums, the fp32 tables taken as three bf16 parts.
#pragma once

#include "mma.cuh"

namespace iuvl {
namespace {

constexpr int kRelWin = 14;  // the window side

// x as three bf16 parts (two values packed in each): hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), so that hi + mid + lo is x to
// about 2^-25 of x and a bf16 q times it is the fp32 product (hi + lo
// alone leave x to 2^-17, coarser than the fp32 sum's own rounding).
__device__ __forceinline__ void split_bf16(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(x.x - hf.x, x.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r.x - mf.x, r.y - mf.y);
}

// relh (t 0) of grid row g and relw (t 1) of grid column g for every line
// (t, g) = warp, warp + warps, ...: the line's 14 query rows (token t ? 14
// r + g : 14 g + r of q, (196, D) bf16 rows ld apart) times the table slice
// T[g] (14 x D fp32, B[c][a] = T[g][a][c]), as products with its three
// bf16 parts, the small parts summed apart from the large; store(token, t,
// a, value) receives each fp32 sum.
template <int D, typename Store>
__device__ __forceinline__ void rel_features(const bf16* qh, int ld, const float* rh,
                                             const float* rw, int warp, int warps, Store store) {
  const int lane = threadIdx.x & 31, lo = lane >> 2, q2 = 2 * (lane & 3);
  for (int line = warp; line < 2 * kRelWin; line += warps) {
    const int t = line / kRelWin, g = line - t * kRelWin;
    const float* T = (t ? rw : rh) + static_cast<size_t>(g) * kRelWin * D;
    const int r_lo = lo, r_hi = lo + 8;
    const int tok_lo = t ? r_lo * kRelWin + g : g * kRelWin + r_lo;
    const int tok_hi = t ? r_hi * kRelWin + g : g * kRelWin + r_hi;
    float acc[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kk * 16 + q2 + (e >> 1) * 8;
        const bool hi_row = e & 1;
        a[e] = (hi_row ? r_hi : r_lo) < kRelWin
                   ? *reinterpret_cast<const uint32_t*>(
                         qh + static_cast<size_t>(hi_row ? tok_hi : tok_lo) * ld + c)
                   : 0u;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int arow = nt * 8 + lo;  // the B column this lane loads: a
        uint32_t bh[2], bm[2], bl[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 x = arow < kRelWin ? *reinterpret_cast<const float2*>(
                                                T + static_cast<size_t>(arow) * D + kk * 16 +
                                                q2 + 8 * u)
                                          : make_float2(0.f, 0.f);
          split_bf16(x, bh[u], bm[u], bl[u]);
        }
        mma16816(small[nt], a, bl[0], bl[1]);
        mma16816(small[nt], a, bm[0], bm[1]);
        mma16816(acc[nt], a, bh[0], bh[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r_lo : r_hi, a = nt * 8 + q2 + (e & 1);
        if (r < kRelWin && a < kRelWin)
          store(e < 2 ? tok_lo : tok_hi, t, a, acc[nt][e] + small[nt][e]);
      }
  }
}

}  // namespace
}  // namespace iuvl
