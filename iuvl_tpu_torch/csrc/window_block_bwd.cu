// Backward of the whole windowed-attention module body (B9): from the
// windows' input xw and the output cotangent g, recompute the forward and
// return dx, dWqkv, dbqkv, dWo, dbo and the gradients of the expanded
// rel-pos tables Rh, Rw. Replaces
// iuvl_tpu/ops/pallas/window_block.py:_block_backward; the Rh -> rel_pos_h
// expansion VJP stays outside, in PyTorch, as _wab_bwd keeps it in XLA.
//
// Bound on the card: operations, ~2.9 GFLOP a 14 x 14 window at ViT-B
// (the qkv and projection products of the forward recompute, dx, dWqkv,
// dWo, and about 3x the attention's forward work; 72.4 GFLOP at 25
// windows, 0.073 ms at 989 TFLOP/s) against ~1 MB of inputs. The TPU
// kernel walked the windows in a serial grid and kept dWqkv, dWo and the
// table gradients as VMEM accumulators across it. On the card the windows
// run in parallel, so the work is split by what depends on what:
//   1. qkv = bf16(bf16(x Wqkv^T) + bf16(b)): B1's own GEMM and epilogue
//      (linear_wgmma.cuh kEpiQkv), each (window, head)'s q, k, v
//      contiguous; do = bf16(g Wo) with Wo read N-major, written
//      head-major (kEpiHeads).
//   2. wbb_attention_kernel, one block of fourteen warps a (window, head)
//      (one block an SM: 181 KB of shared memory at head dim 64, 216 KB at
//      80): the window's q, bf16(q d^-1/2), k, v and do stay in shared
//      memory (k and v with key 14 g + c at slot 16 g + c, as B1 keeps k,
//      so that a 16-key group is one grid row), relh / relw are B1's
//      (window_rel.cuh), and the scores live in registers (mma.sync), one
//      16-slot group at a time. A warp takes a 16-query strip (13 strips)
//      in three passes: the row max m and the sum l of exp(s - m) (l
//      rescaled as m grows); p = exp(s - m) (1 / l), o_h = bf16(p) v (for
//      dWo) and delta = rowsum(dp p) from the unrounded p; then ds = p (dp -
//      delta) in fp32, dq = scale bf16(ds) k, drelh / drelw as fp32 sums of
//      ds over a key row (a 16-slot group, across the lane quad) and a key
//      column (each lane's slots, across the groups), rounded to bf16, and
//      the rel-pos terms drelh Rh + drelw Rw in fp32. The rows' m, 1 / l and
//      delta stay in shared memory; after a block barrier a warp takes a
//      key grid row (14) and walks the query strips for dv = bf16(p)^T do
//      and dk = scale bf16(ds)^T q, p and ds recomputed from the transposed
//      scores. No p or ds row leaves the SM.
//   3. dx = bf16(dqkv Wqkv) (Wqkv read N-major); dWqkv = dqkv^T x and dWo
//      = g^T o over every token row (both operands M-/N-major, split-K in
//      thread block clusters, the splits added in order); dRh / dRw from
//      the compact drelh / drelw rows (nW x heads x 196 x 28 bf16) against
//      q (wbb_table_kernel, 16 splits over the (window, head) pairs, then
//      table_sum_kernel); dbqkv, dbo as two-pass column sums. Every sum
//      runs in a fixed order: two launches give the same bits.
// Measured (ptxas on the card; no spills): wbb_attention_kernel 128
// registers, 181,504 / 215,808 bytes a block at head dim 64 / 80;
// wbb_table_kernel 48 / 95 registers; the GEMMs 110-122. On the card (H100
// SXM, 700 W; tools/kernel_ab.py, PERF.md §6) 0.489 ms at ViT-B 1024^2 (the
// earlier wmma design: 1.673): qkv 0.056, do 0.022, attention 0.207, dx
// 0.043, dWqkv 0.048, dWo 0.029, tables 0.045, sums 0.016; 50 windows
// 0.841, ViT-H 0.906, 9 windows 0.294. The attention's first build held
// eight warps of 255 registers a block, two strips or key rows a warp and
// four passes (the max and the sum apart): 0.470 ms at ViT-B; fourteen
// warps with one strip each, 0.287; the reciprocal in place of a division
// an element, 0.203.
//
// The head dim is a template parameter of the attention, 64 (ViT-B/L) or
// 80 (ViT-H); the scores are bf16(q d^-1/2) . k as in the forward (exact at
// 64).
//
// Rounding points follow the plain version, window_block_backward_plain
// (the arithmetic of the TPU kernel on the forward's rounding points):
// qkv = bf16(bf16(x W^T) + bf16(b)); relh, relw = bf16(q . R); scores and
// softmax fp32; o_h = bf16(bf16(p) v); do = bf16(g Wo); ds = p (dp -
// rowsum(dp p)) in fp32, rounded to bf16 for dq and dk; the rel-pos
// cotangents drelh, drelw rounded to bf16; dq, dk, dv, dx bf16; weight,
// bias and table gradients fp32.
#include "linear_wgmma.cuh"
#include "window_rel.cuh"

namespace iuvl {
namespace {

constexpr int kWin = 14;
constexpr int kN = kWin * kWin;     // 196 tokens a window
constexpr int kNP = 208;            // tokens padded to 16
constexpr int kSlots = kWin * 16;   // key slots: a grid row of 14 keys in 16
constexpr int kBwdWarps = 14;      // a query strip a warp (13), then a key grid row (14)
constexpr int kRelT = kNP + 8;      // a RELT row: one feature of every query (bf16)
constexpr int kDrLd = 2 * kWin;     // a query's drelh | drelw (bf16)
constexpr int kTableSplits = 16;    // wbb_table_kernel's splits of the pairs
constexpr float kBig = 1e30f;       // m of a pad query: exp(s - m) = 0

template <int D>
struct WbbSmem {
  static constexpr int kLd = D + 8;  // K, V, Q, bf16(q scale), dO rows, padded (bank conflicts)
  static constexpr size_t kBytes =
      ((2 * kSlots + 3 * kNP) * kLd + 2 * kWin * kRelT + kBwdWarps * 16 * kDrLd) * sizeof(bf16) +
      3 * kNP * sizeof(float);
};

// Two bf16 values (lo at p) as fp32.
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// bf16(x * scale) of a packed pair.
__device__ __forceinline__ uint32_t scale_bf2(uint32_t raw, float scale) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return pack_bf16(x.x * scale, x.y * scale);
}

// s = (q.k + relh[row, g]) + relw[row, c] of the strip (A fragments qf)
// against the 16 key slots of grid row g (slot c = 8 j + 2 (lane % 4) + x of
// s[j][2 u + x], row lo + 8 u). relt: the RELT rows (feature, query);
// rw[u][2 j + x]: relw of the lane's row u at slot c (-inf at c >= 14, the
// masked slots).
template <int D>
__device__ __forceinline__ void group_scores(float (&s)[2][4], const uint32_t (&qf)[D / 16][4],
                                             const bf16* Ks, int g, const bf16* relt,
                                             int row_lo, int row_hi, const float (&rw)[2][4]) {
  s[0][0] = s[0][1] = s[0][2] = s[0][3] = s[1][0] = s[1][1] = s[1][2] = s[1][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    ldb_rows(b, Ks, D + 8, 16 * g, kk * 16);
    mma16816(s[0], qf[kk], b[0], b[1]);
    mma16816(s[1], qf[kk], b[2], b[3]);
  }
  const float rh[2] = {to_f(relt[g * kRelT + row_lo]), to_f(relt[g * kRelT + row_hi])};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[j][2 * u] = (s[j][2 * u] + rh[u]) + rw[u][2 * j];
      s[j][2 * u + 1] = (s[j][2 * u + 1] + rh[u]) + rw[u][2 * j + 1];
    }
}

// dp = do v^T of the strip's rows row0 .. (do read from dOs) against grid
// row g's 16 value slots.
template <int D>
__device__ __forceinline__ void group_dp(float (&dp)[2][4], const bf16* dOs, const bf16* Vs,
                                         int row0, int g) {
  dp[0][0] = dp[0][1] = dp[0][2] = dp[0][3] = dp[1][0] = dp[1][1] = dp[1][2] = dp[1][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    lda_rows(a, dOs, D + 8, row0, kk * 16);
    ldb_rows(b, Vs, D + 8, 16 * g, kk * 16);
    mma16816(dp[0], a, b[0], b[1]);
    mma16816(dp[1], a, b[2], b[3]);
  }
}

// acc += bf16(x) T over grid row g's 16 slots (x: the strip's two 8-slot
// accumulator tiles; T: V for o, K for dq, slot rows).
template <int D>
__device__ __forceinline__ void group_pv(float (&acc)[D / 8][4], const float (&x)[2][4],
                                         const bf16* T, int g) {
  uint32_t a[4];
  acc_to_a(a, x[0], x[1]);
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    uint32_t b[4];
    ldb_cols(b, T, D + 8, dn * 16, 16 * g);  // B[slot][c] = T[slot][c]
    mma16816(acc[2 * dn], a, b[0], b[1]);
    mma16816(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

// One (window, head) pair a block (see the header): qkv (nW, 3, heads, 196,
// D) and dob (nW, heads, 196, D) head-major; obuf (T, C) and dqkv (T, 3 C)
// token-major; drel (nW heads, 196, 28) bf16.
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32, 1) wbb_attention_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dob, const float* __restrict__ rh,
    const float* __restrict__ rw, bf16* __restrict__ obuf, bf16* __restrict__ dqkv,
    bf16* __restrict__ drel, int heads, float scale) {
  constexpr int kLd = WbbSmem<D>::kLd, kThr = kBwdWarps * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // kSlots x kLd: key 14 g + c at slot 16 g + c
  bf16* Vs = Ks + kSlots * kLd;              // the same slots
  bf16* Qs = Vs + kSlots * kLd;              // kNP x kLd, rows past 196 zero
  bf16* Qsc = Qs + kNP * kLd;                // bf16(q scale), written by the strips
  bf16* dOs = Qsc + kNP * kLd;               // kNP x kLd
  bf16* RELT = dOs + kNP * kLd;              // 28 x kRelT: relh (a), then relw (14 + a)
  bf16* DR = RELT + 2 * kWin * kRelT;        // a warp's 16 x kDrLd drelh | drelw rows
  float* Ms = reinterpret_cast<float*>(DR + kBwdWarps * 16 * kDrLd);
  float* Ls = Ms + kNP;  // 1 / l of every row
  float* Dl = Ls + kNP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  const int q2 = 2 * (lane & 3);
  const int win = blockIdx.x / heads, hd = blockIdx.x - win * heads;
  const int C = heads * D, C3 = 3 * C;
  const size_t plane = static_cast<size_t>(kN) * D;  // one (window, which, head) tile
  const bf16* qh = qkv + (static_cast<size_t>(win) * 3 * heads + hd) * plane;
  const bf16* kh = qh + heads * plane;
  const bf16* vh = kh + heads * plane;
  const bf16* doh = dob + (static_cast<size_t>(win) * heads + hd) * plane;
  for (int i = tid; i < kSlots * (D / 8); i += kThr) {
    const int slot = i / (D / 8), c8 = (i - slot * (D / 8)) * 8, c = slot & 15;
    const bool in = c < kWin;
    const size_t src = static_cast<size_t>(in ? (slot >> 4) * kWin + c : 0) * D + c8;
    cp_async16_zfill(Ks + slot * kLd + c8, kh + src, in);
    cp_async16_zfill(Vs + slot * kLd + c8, vh + src, in);
  }
  cp_rows<D>(Qs, kLd, qh, 0, kNP, kN, tid, kThr);
  cp_rows<D>(dOs, kLd, doh, 0, kNP, kN, tid, kThr);
  cp_async_commit();
  for (int i = tid; i < 2 * kWin * (kRelT - kN); i += kThr)  // the pad queries' features
    RELT[(i / (kRelT - kN)) * kRelT + kN + i % (kRelT - kN)] = to_bf(0.f);
  rel_features<D>(qh, D, rh, rw, warp, kBwdWarps, [&](int tok, int t, int a, float v) {
    RELT[(t * kWin + a) * kRelT + tok] = to_bf(v);
  });
  cp_async_wait<0>();
  __syncthreads();  // q, k, v, do and every query's relh | relw are in shared memory

  const size_t tok0 = static_cast<size_t>(win) * kN;  // the window's first token row
  // ---- a query strip a warp: statistics, o_h, dq, drelh, drelw ----
  if (warp < kNP / 16) {
    const int row0 = warp * 16, row_lo = row0 + lo, row_hi = row_lo + 8;
    bf16* drw = DR + warp * 16 * kDrLd;
    float rwv[2][4];  // relw of the lane's rows at its slots (-inf at 14, 15)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * (j >> 1) + q2 + (j & 1);
        rwv[u][j] = c < kWin ? to_f(RELT[(kWin + c) * kRelT + row_lo + 8 * u]) : kNegInf;
      }
    uint32_t qf[D / 16][4];  // bf16(q * scale) of the strip, also kept in Qsc for the keys' pass
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      lda_rows(qf[kk], Qs, kLd, row0, kk * 16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qf[kk][e] = scale_bf2(qf[kk][e], scale);
        *reinterpret_cast<uint32_t*>(Qsc + (row_lo + 8 * (e & 1)) * kLd + kk * 16 + q2 +
                                     8 * (e >> 1)) = qf[kk][e];
      }
    }
    // pass 1: the row max m and sum l of exp(s - m), l rescaled as m grows
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    for (int g = 0; g < kWin; ++g) {
      float s[2][4];
      group_scores<D>(s, qf, Ks, g, RELT, row_lo, row_hi, rwv);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float mx = fmaxf(fmaxf(s[0][2 * u], s[0][2 * u + 1]), fmaxf(s[1][2 * u], s[1][2 * u + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[u], mx);
        l[u] = l[u] * expf(m[u] - mn) + ((expf(s[0][2 * u] - mn) + expf(s[0][2 * u + 1] - mn)) +
                                         (expf(s[1][2 * u] - mn) + expf(s[1][2 * u + 1] - mn)));
        m[u] = mn;
      }
    }
#pragma unroll
    float il[2];  // 1 / l, taken once a row (a division an element cost 29% of the kernel)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      il[u] = 1.f / l[u];
    }
    // pass 2: p = exp(s - m) (1 / l); o_h = bf16(p) v; delta = rowsum(dp p)
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float dl[2] = {0.f, 0.f};
    for (int g = 0; g < kWin; ++g) {
      float s[2][4], dp[2][4];
      group_scores<D>(s, qf, Ks, g, RELT, row_lo, row_hi, rwv);
      group_dp<D>(dp, dOs, Vs, row0, g);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]) * il[e >> 1];
          dl[e >> 1] += s[j][e] * dp[j][e];
        }
      group_pv<D>(acc, s, Vs, g);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      dl[u] += __shfl_xor_sync(0xffffffffu, dl[u], 1);
      dl[u] += __shfl_xor_sync(0xffffffffu, dl[u], 2);
    }
    store_strip_rows<D>(obuf + tok0 * C + hd * D, acc, row0, kN, C);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = row_lo + 8 * u;
        Ms[row] = row < kN ? m[u] : kBig;
        Ls[row] = row < kN ? il[u] : 1.f;
        Dl[row] = row < kN ? dl[u] : 0.f;
      }
    }
    // pass 3: ds = p (dp - delta); dq = bf16(ds) k; drelh, drelw
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float dw[2][4] = {};
    for (int g = 0; g < kWin; ++g) {
      float s[2][4], dp[2][4];
      group_scores<D>(s, qf, Ks, g, RELT, row_lo, row_hi, rwv);
      group_dp<D>(dp, dOs, Vs, row0, g);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = expf(s[j][e] - m[e >> 1]) * il[e >> 1] * (dp[j][e] - dl[e >> 1]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // drelh of grid row g: the group's 16 slots
        float t = (s[0][2 * u] + s[0][2 * u + 1]) + (s[1][2 * u] + s[1][2 * u + 1]);
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        if ((lane & 3) == 0) drw[(lo + 8 * u) * kDrLd + g] = to_bf(t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // drelw: the lane's slots, summed over the groups
          dw[u][2 * j] += s[j][2 * u];
          dw[u][2 * j + 1] += s[j][2 * u + 1];
        }
      }
      group_pv<D>(acc, s, Ks, g);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * (j >> 1) + q2 + (j & 1);
        if (c < kWin) drw[(lo + 8 * u) * kDrLd + kWin + c] = to_bf(dw[u][j]);
      }
    __syncwarp();
    bf16* drel_wh = drel + static_cast<size_t>(blockIdx.x) * kN * kDrLd;
    for (int i = lane; i < 16 * (kDrLd / 2); i += 32) {  // the strip's compact drel rows
      const int r = i / (kDrLd / 2), w2 = i - r * (kDrLd / 2);
      if (row0 + r < kN)
        reinterpret_cast<uint32_t*>(drel_wh + static_cast<size_t>(row0 + r) * kDrLd)[w2] =
            reinterpret_cast<const uint32_t*>(drw + r * kDrLd)[w2];
    }
    // dq = scale bf16(ds) k + (drelh Rh[row / 14] + drelw Rw[row % 14])
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = row_lo + 8 * u;
      if (row >= kN) continue;
      const float* Rh = rh + static_cast<size_t>(row / kWin) * kWin * D + q2;
      const float* Rw = rw + static_cast<size_t>(row % kWin) * kWin * D + q2;
      const bf16* dr = drw + (lo + 8 * u) * kDrLd;
      float th[D / 8][2] = {}, tw[D / 8][2] = {};
      for (int a = 0; a < kWin; ++a) {
        const float dh = to_f(dr[a]), dv = to_f(dr[kWin + a]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(Rh + a * D + 8 * j));
          const float2 y = __ldg(reinterpret_cast<const float2*>(Rw + a * D + 8 * j));
          th[j][0] += dh * x.x;
          th[j][1] += dh * x.y;
          tw[j][0] += dv * y.x;
          tw[j][1] += dv * y.y;
        }
      }
      bf16* out = dqkv + (tok0 + row) * C3 + hd * D + q2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[j][2 * u] * scale + (th[j][0] + tw[j][0]),
                      acc[j][2 * u + 1] * scale + (th[j][1] + tw[j][1]));
    }
  }
  __syncthreads();  // every query's m, l, delta and bf16(q scale) are in shared memory

  // ---- a key grid row a warp: dv = bf16(p)^T do, dk = scale bf16(ds)^T q ----
  if (warp < kWin) {
    const int g = warp;
    const bool key_in[2] = {lo < kWin, lo + 8 < kWin};
    const bf16* rh_row = RELT + g * kRelT;  // relh[query][g]
    const bf16* rw_row[2] = {RELT + (kWin + lo) * kRelT,
                             RELT + (kWin + min(lo + 8, kWin - 1)) * kRelT};  // relw[query][c]
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    for (int qt = 0; qt < kNP / 16; ++qt) {
      float st[2][4] = {}, dpt[2][4] = {};  // s^T and dp^T: key rows x the tile's 16 queries
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b[4];
        lda_rows(a, Ks, kLd, 16 * g, kk * 16);
        ldb_rows(b, Qsc, kLd, 16 * qt, kk * 16);
        mma16816(st[0], a, b[0], b[1]);
        mma16816(st[1], a, b[2], b[3]);
        lda_rows(a, Vs, kLd, 16 * g, kk * 16);
        ldb_rows(b, dOs, kLd, 16 * qt, kk * 16);
        mma16816(dpt[0], a, b[0], b[1]);
        mma16816(dpt[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int i0 = 16 * qt + 8 * jn + q2;  // the lane's queries i0, i0 + 1
        const float2 mm = *reinterpret_cast<const float2*>(Ms + i0);
        const float2 ll = *reinterpret_cast<const float2*>(Ls + i0);
        const float2 dd = *reinterpret_cast<const float2*>(Dl + i0);
        const float2 hh = ld_bf2(rh_row + i0);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 ww = ld_bf2(rw_row[u] + i0);
          const float s0 = (st[jn][2 * u] + hh.x) + ww.x, s1 = (st[jn][2 * u + 1] + hh.y) + ww.y;
          const float p0 = key_in[u] ? expf(s0 - mm.x) * ll.x : 0.f;
          const float p1 = key_in[u] ? expf(s1 - mm.y) * ll.y : 0.f;
          st[jn][2 * u] = p0;
          st[jn][2 * u + 1] = p1;
          dpt[jn][2 * u] = p0 * (dpt[jn][2 * u] - dd.x);
          dpt[jn][2 * u + 1] = p1 * (dpt[jn][2 * u + 1] - dd.y);
        }
      }
      uint32_t ap[4], ad[4];
      acc_to_a(ap, st[0], st[1]);
      acc_to_a(ad, dpt[0], dpt[1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldb_cols(b, dOs, kLd, dn * 16, 16 * qt);  // B[query][c] = do[query][c]
        mma16816(dv[2 * dn], ap, b[0], b[1]);
        mma16816(dv[2 * dn + 1], ap, b[2], b[3]);
        ldb_cols(b, Qs, kLd, dn * 16, 16 * qt);  // B[query][c] = q[query][c]
        mma16816(dk[2 * dn], ad, b[0], b[1]);
        mma16816(dk[2 * dn + 1], ad, b[2], b[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (!key_in[u]) continue;
      bf16* out = dqkv + (tok0 + g * kWin + lo + 8 * u) * C3 + hd * D + q2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(out + C + 8 * j) =
            pack_bf16(dk[j][2 * u] * scale, dk[j][2 * u + 1] * scale);
        *reinterpret_cast<uint32_t*>(out + 2 * C + 8 * j) =
            pack_bf16(dv[j][2 * u], dv[j][2 * u + 1]);
      }
    }
  }
}

// part[z][t][x][a][e]: split z's share of dRh (t 0) and dRw (t 1),
// dRh[x][a][e] = sum drelh[pair][14 x + c][a] q[pair][14 x + c][e] and
// dRw[x][a][e] = sum drelw[pair][14 r + x][a] q[pair][14 r + x][e] over
// the split's (window, head) pairs in order, c (r) in order. Grid (28 lines
// (t, x), kTableSplits); the rows of kTablePairs pairs land in shared
// memory at a time.
constexpr int kTablePairs = 8;

template <int D>
__global__ void __launch_bounds__(256) wbb_table_kernel(const bf16* __restrict__ qkv,
                                                        const bf16* __restrict__ drel,
                                                        float* __restrict__ part, int pairs,
                                                        int heads) {
  constexpr int kOut = kWin * D, kPer = (kOut + 255) / 256;
  __shared__ __align__(16) bf16 qs[kTablePairs][kWin][D];
  __shared__ float ds[kTablePairs][kWin][kWin];
  const int t = blockIdx.x / kWin, x = blockIdx.x - t * kWin, z = blockIdx.y;
  const int per = (pairs + gridDim.y - 1) / gridDim.y;
  const int p0 = z * per, p1 = min(pairs, p0 + per);
  float acc[kPer] = {};
  for (int pb = p0; pb < p1; pb += kTablePairs) {
    const int nb = min(kTablePairs, p1 - pb);
    __syncthreads();  // the previous pairs' rows are read
    for (int i = threadIdx.x; i < nb * kWin * (D / 8); i += 256) {
      const int b = i / (kWin * (D / 8)), r = i - b * kWin * (D / 8), c = r / (D / 8);
      const int e8 = (r - c * (D / 8)) * 8, pr = pb + b, win = pr / heads, hd = pr - win * heads;
      const int tok = t ? c * kWin + x : x * kWin + c;
      *reinterpret_cast<uint4*>(&qs[b][c][e8]) = *reinterpret_cast<const uint4*>(
          qkv + ((static_cast<size_t>(win) * 3 * heads + hd) * kN + tok) * D + e8);
    }
    for (int i = threadIdx.x; i < nb * kWin * kWin; i += 256) {
      const int b = i / (kWin * kWin), r = i - b * kWin * kWin, c = r / kWin, a = r - c * kWin;
      const int tok = t ? c * kWin + x : x * kWin + c;
      ds[b][c][a] = to_f(drel[(static_cast<size_t>(pb + b) * kN + tok) * kDrLd + t * kWin + a]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int o = threadIdx.x + 256 * k;
      if (o >= kOut) break;
      const int a = o / D, e = o - a * D;
      float s = acc[k];
      for (int b = 0; b < nb; ++b)
        for (int c = 0; c < kWin; ++c) s += ds[b][c][a] * to_f(qs[b][c][e]);
      acc[k] = s;
    }
  }
  float* out = part + (static_cast<size_t>(z) * 2 + t) * kWin * kOut + x * kOut;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int o = threadIdx.x + 256 * k;
    if (o < kOut) out[o] = acc[k];
  }
}

// out[i] = sum_z part[z n + i] over the table kernel's splits, in order.
__global__ void table_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                 int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[static_cast<size_t>(z) * n + i];
  out[i] = s;
}

template <int D>
int window_block_bwd(const bf16* xw, const bf16* g, const bf16* wqkv, const float* bqkv,
                     const bf16* wo, const float* rh, const float* rw, bf16* qkv, bf16* dob,
                     bf16* obuf, bf16* dqkv, bf16* drel, float* part, bf16* dx, float* dwqkv,
                     float* dbqkv, float* dwo, float* dbo, float* drhw, int n_windows, int C,
                     int splits_qkv, int splits_o, cudaStream_t s) {
  const int T = n_windows * kN, C3 = 3 * C, heads = C / D, pairs = n_windows * heads;
  // 1. the forward's qkv; do = bf16(g Wo), head-major
  IUVL_TRY(linear_wgmma<kEpiQkv>(xw, wqkv, bqkv, qkv, T, C3, C, C, D, s));
  LinearParams p{g, wo, nullptr, dob, T, C, C, 0, C, C, D, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiHeads, kRowK, kMn>(p, s)));
  // 2. the attention backward, a block a (window, head)
  constexpr size_t smem = WbbSmem<D>::kBytes;
  IUVL_TRY(static_cast<int>(cudaFuncSetAttribute(
      wbb_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem))));
  wbb_attention_kernel<D><<<pairs, kBwdWarps * 32, smem, s>>>(
      qkv, dob, rh, rw, obuf, dqkv, drel, heads, 1.f / sqrtf(static_cast<float>(D)));
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 3. dx; the weight gradients over every token row; the table gradients;
  // the bias gradients
  p = LinearParams{dqkv, wqkv, nullptr, dx, T, C, C3, 0, C, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiBf16, kRowK, kMn>(p, s)));
  p = LinearParams{dqkv, xw, nullptr, dwqkv, C3, C, T, C3, C, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiF32, kMn, kMn>(p, s, splits_qkv)));
  p = LinearParams{g, obuf, nullptr, dwo, C, C, T, C, C, 0, 0, nullptr, nullptr, nullptr, 0};
  IUVL_TRY((linear_gemm<kEpiF32, kMn, kMn>(p, s, splits_o)));
  const int table_splits = pairs < kTableSplits ? pairs : kTableSplits;
  wbb_table_kernel<D><<<dim3(2 * kWin, table_splits), 256, 0, s>>>(qkv, drel, part, pairs, heads);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  table_sum_kernel<<<(2 * kN * D + 255) / 256, 256, 0, s>>>(part, drhw, table_splits,
                                                             2 * kN * D);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  ColsumJobs jobs{{{dqkv, dbqkv, C3, 0}, {g, dbo, C, 0}}};
  return colsums(jobs, 2, T, part + static_cast<size_t>(kTableSplits) * 2 * kN * D, s);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// xw, g, dx: (nW * 196, C) bf16 token rows of the windows; wqkv (3C, C) and
// wo (C, C) bf16 in nn.Linear layout; bqkv (3C) fp32; rh, rw (14, 14, d)
// fp32 with d (head_dim) 64 or 80. Scratch (wrapper-allocated): qkv (nW, 3,
// heads, 196, d) and dob (nW, heads, 196, d) bf16; obuf (nW*196, C) and
// dqkv (nW*196, 3C) bf16; drel (nW*heads, 196, 28) bf16; part fp32, 16 x 2
// x 196 d for the table gradients' splits, then the column sums' chunks
// (ops/cuda/build.py colsum_scratch(nW*196, 3C, 2)). Outputs: dx; dwqkv
// (3C, C), dbqkv (3C), dwo (C, C), dbo (C) and drhw (2, 14, 14, d) = (dRh,
// dRw), all fp32. splits_qkv, splits_o: dWqkv's and dWo's split-K (split_k
// in ops/cuda/build.py).
extern "C" int iuvl_window_block_bwd(const void* xw, const void* g, const void* wqkv,
                                     const void* bqkv, const void* wo, const void* rh,
                                     const void* rw, void* qkv, void* dob, void* obuf,
                                     void* dqkv, void* drel, void* part, void* dx, void* dwqkv,
                                     void* dbqkv, void* dwo, void* dbo, void* drhw,
                                     int n_windows, int C, int win, int head_dim, int splits_qkv,
                                     int splits_o, void* stream) {
  if (win != kWin || n_windows < 1 || C % 128 || C % head_dim)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x_ = static_cast<const bf16*>(xw);
  const auto* g_ = static_cast<const bf16*>(g);
  const auto* wq = static_cast<const bf16*>(wqkv);
  const auto* bq = static_cast<const float*>(bqkv);
  const auto* wo_ = static_cast<const bf16*>(wo);
  const auto* th = static_cast<const float*>(rh);
  const auto* tw = static_cast<const float*>(rw);
  auto* qkv_ = static_cast<bf16*>(qkv);
  auto* dob_ = static_cast<bf16*>(dob);
  auto* ob = static_cast<bf16*>(obuf);
  auto* dq = static_cast<bf16*>(dqkv);
  auto* dr = static_cast<bf16*>(drel);
  auto* pt = static_cast<float*>(part);
  auto* dx_ = static_cast<bf16*>(dx);
  auto* dwq = static_cast<float*>(dwqkv);
  auto* dbq = static_cast<float*>(dbqkv);
  auto* dwo_ = static_cast<float*>(dwo);
  auto* dbo_ = static_cast<float*>(dbo);
  auto* drt = static_cast<float*>(drhw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return window_block_bwd<64>(x_, g_, wq, bq, wo_, th, tw, qkv_, dob_, ob, dq, dr, pt, dx_,
                                  dwq, dbq, dwo_, dbo_, drt, n_windows, C, splits_qkv, splits_o, s);
    case 80:
      return window_block_bwd<80>(x_, g_, wq, bq, wo_, th, tw, qkv_, dob_, ob, dq, dr, pt, dx_,
                                  dwq, dbq, dwo_, dbo_, drt, n_windows, C, splits_qkv, splits_o, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
