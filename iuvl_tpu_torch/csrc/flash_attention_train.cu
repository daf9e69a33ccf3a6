// Flash attention for training (B11): the forward stores the per-row
// logsumexp; the backward recomputes the probabilities from it in two
// passes (dq over query tiles; dk and dv over key tiles).
//   o = softmax(q k^T) v,  lse = logsumexp(q k^T)   (scale folded into q)
//   dq = ds k, dk = ds^T q, dv = p^T do,  ds = p (do v^T - rowsum(do o))
// Replaces iuvl_tpu/ops/pallas/flash_attention.py:flash_attention
// (_flash_forward with lse, _flash_backward's dq and dk/dv kernels). The
// SAM global blocks call it on rel-pos-augmented q, k (d_qk = d + h + w:
// 192 = 64 + 64 + 64 for ViT-B/L at 1024^2, 208 for ViT-H, 164 for ViT-B
// at 800^2) and v (d_v the head dim, 64 or 80): 12 heads x 4096 tokens at
// ViT-B 1024^2. d_qk is instantiated at multiples of 32 from 128 to 256
// (the wrapper zero-pads q and k to the next one) and d_v at 64 and 80.
// N need not be a multiple of 64 (2500 at 800^2): rows past N load as
// zero, keys past N score -inf (p = 0 in the backward), and queries past N
// have q = do = 0, so ds = 0 for them whatever p is.
//
// Bound on the card: operations. The function needs 2 N^2 (d_qk + d_v)
// per head for the forward (103 GFLOP at the slice's shape, 0.104 ms at
// 989 TFLOP/s) and 2 N^2 (3 d_qk + 2 d_v) for the backward (s once from
// lse, then dp, dq, dk, dv: 283 GFLOP, 0.286 ms). The two backward passes
// here each recompute s and dp, 2 N^2 (4 d_qk + 3 d_v) (386 GFLOP, 36% over
// the function's need): the price of keeping dq and dk/dv as register sums
// written once, with no atomics. The N x N scores never reach device
// memory. The TPU grid walked (head, q block, k block) in order with VMEM
// accumulators; here a block of four warps owns a 64-row tile and loops
// over the other side's 64-row tiles, each warp a 16-row strip, and every
// product is mma.sync m16n8k16 with s, p, dp, ds and the sums in registers
// (mma.cuh), p and ds packed to bf16 straight into the A operand of the
// next product. The other side's tiles come by cp.async into a two-stage
// ring: the next tile's copy is issued behind the one block barrier a tile
// and lands under this tile's products.
// - Forward: one online pass (the recipe of B2b's streaming forward,
//   flash_attention_rowbias.cu): a warp's q fragments stay in registers
//   (d_qk / 16 depth steps; the Q tile lands in K's second stage and is
//   gone once they are loaded), row max and sum by quad shuffles, alpha
//   rescales m, l and the output sums in registers, and each key tile's
//   p v is summed from zero and then added, acc alpha + p v, with expf, as
//   the TPU kernel computes it. Shared memory: two stages of K and V, 69,632
//   bytes at <192, 64>, 81,920 at <224, 80>. Registers (ptxas on the card,
//   no spills): 212 and 238, so two blocks (8 warps) an SM. Shared memory
//   would hold three at <192, 64>, but at the 168 registers that leaves
//   ptxas spills 28 bytes, and that build took 0.4599 ms against this one's
//   0.4687 at the main shape and ~0.25 against 0.195 at N 2500
//   (tools/kernel_ab.py, H100 SXM 700 W; PERF.md). ex2.approx for expf and
//   p v summed into the output sums take 168 registers and 0.39-0.40 ms,
//   but move o's bits off the TPU kernel's order (PERF.md: the train gates).
// - dq pass: a block per 64-query tile; the Q tile stays in shared memory
//   and is reread by ldmatrix each key tile (its 12 depth steps at d_qk 192
//   would cost 48 registers beside dq's 96); the warp's dO fragments are
//   held in registers (dO lands in V's second stage first). s, p, dp, ds
//   for a 16 x 64 strip in registers; dq += ds k. 95,232 bytes at
//   <192, 64>, 111,616 at <224, 80>: two blocks an SM.
// - dk/dv pass: a block per 64-key tile; the K tile stays in shared memory,
//   the warp's V fragments in registers (V lands in dO's second stage
//   first); Q, dO, lse and delta stream. A warp works on s^T and dp^T (its
//   16 keys as rows) beside dk (d_qk / 2 registers) and dv (d_v / 2).
//   96,256 bytes at <192, 64>, 112,640 at <224, 80>: two blocks an SM.
// - Pieces: where a whole 64-row tile's s and dp (64 registers) do not fit
//   beside the sums, a pass works on the tile in two pieces of 32, one at a
//   time (FlashLayout::kDqSub, kDkvSub), summing in the same order (the
//   same bits). ptxas on the card: at <192, 64> one piece, dq 248 and dk/dv
//   248 registers; at <224, 80> two, 249 and 255, where one piece spills 32
//   and 44 bytes. Two pieces cost 3-9% where one fits (tools/kernel_ab.py:
//   dk/dv 0.704 against 0.661 ms at the main shape), so dk's columns are
//   neither split between warps nor moved through shared memory.
// Every output element is summed by one block in a fixed order and
// written once: two launches give the same bits.
//
// Rounding points follow the TPU kernels: s and the softmax in fp32; the
// unnormalised p = exp(s - m) rounded to bf16 for p @ v, per 64-key tile;
// o = bf16(acc / l); lse = m + log(l); in the backward p = exp(s - lse) in
// fp32, ds in fp32 rounded to bf16 before both products, dv from bf16(p);
// dq, dk, dv are fp32 sums rounded once. delta = rowsum(do * o) is a small
// pass of its own, as the TPU left it to XLA.
#include "mma.cuh"

namespace iuvl {
namespace {

constexpr int kFT = 128;              // threads: 4 warps, each a 16-row strip
constexpr int kT = 64;                // query / key tile
constexpr size_t kSmemBlock = 232448;  // shared memory a block may have (227 KB)

// The backward passes' pieces of the other side's 64-row tile (1 or 2):
// FlashLayout's choice unless set by -D (to compare).
#ifndef IUVL_FLASH_DQ_SUB
#define IUVL_FLASH_DQ_SUB 0
#endif
#ifndef IUVL_FLASH_DKV_SUB
#define IUVL_FLASH_DKV_SUB 0
#endif
// The exponentials: expf (1), or ex2.approx (0; -D to compare).
#ifndef IUVL_FLASH_EXACT_EXP
#define IUVL_FLASH_EXACT_EXP 1
#endif
constexpr bool kExactExp = IUVL_FLASH_EXACT_EXP;
// The forward's p v: each key tile's product summed from zero and then
// added to the rescaled output, acc alpha + p v, as the TPU kernel sums it
// (1), or accumulated into the output sums (0; -D to compare).
#ifndef IUVL_FLASH_TILE_SUM
#define IUVL_FLASH_TILE_SUM 1
#endif

// p = exp(s - lse) for lse given in natural units (lse) and log2 units (ll).
__device__ __forceinline__ float p_from_lse(float s, float lse, float ll) {
  return kExactExp ? expf(s - lse) : ex2(fmaf(s, kLog2e, -ll));
}

template <int DQK, int DV>
struct FlashLayout {
  static constexpr int kLdK = DQK + 8, kLdV = DV + 8;  // pitches (bf16)
  static constexpr int kTileK = kT * kLdK, kTileV = kT * kLdV;  // tiles (bf16)
  // forward: two stages of {K, V}
  static constexpr size_t kFwd = 2 * (kTileK + kTileV) * sizeof(bf16);
  // dq pass: Q, then two stages of K, two of V
  static constexpr size_t kDq = (3 * kTileK + 2 * kTileV) * sizeof(bf16);
  // dk/dv pass: K, then two stages of {Q, dO, lse, delta}
  static constexpr size_t kStage = (kTileK + kTileV) * sizeof(bf16) + 2 * kT * sizeof(float);
  static constexpr size_t kDkv = kTileK * sizeof(bf16) + 2 * kStage;
  // Pieces a tile in the dq pass: two where dq's d_qk / 2 registers and
  // the dO fragments' d_v / 4 leave too few for a whole tile's s and dp.
  static constexpr int kDqSub =
      IUVL_FLASH_DQ_SUB ? IUVL_FLASH_DQ_SUB : (DQK / 2 + DV / 4 > 112 ? 2 : 1);
  // And in the dk/dv pass, beside dk (d_qk / 2), dv (d_v / 2) and the V
  // fragments (d_v / 4).
  static constexpr int kDkvSub =
      IUVL_FLASH_DKV_SUB ? IUVL_FLASH_DKV_SUB : (DQK / 2 + DV / 2 + DV / 4 > 144 ? 2 : 1);
};

// lse or delta of rows [r0, r0 + kT) into shared memory, 0 past n: by
// cp.async where four rows are whole and 16-byte aligned, else by plain
// loads (seen behind the next block barrier, as the copies are).
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int r0, int n) {
  if (threadIdx.x < kT / 4) {
    const int r = threadIdx.x * 4;
    if (r0 + r + 4 <= n && (reinterpret_cast<size_t>(src + r0 + r) & 15) == 0) {
      cp_async16_zfill(dst + r, src + r0 + r, true);
    } else {
      for (int u = 0; u < 4; ++u) dst[r + u] = r0 + r + u < n ? src[r0 + r + u] : 0.f;
    }
  }
}

// o += bf16(p) v over the 64 keys of the tile Vt (pitch ld), each 16-column
// chunk of the product summed from zero and then added to o.
template <int D>
__device__ __forceinline__ void pv_tile_sum(float (&o)[D / 8][4], const float (&p)[8][4],
                                            const bf16* Vt, int ld) {
  uint32_t a[4][4];
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) acc_to_a(a[kp], p[2 * kp], p[2 * kp + 1]);
#pragma unroll
  for (int dn = 0; dn < D / 16; ++dn) {
    float t[2][4] = {};
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      uint32_t b[4];
      ldb_cols(b, Vt, ld, dn * 16, kp * 16);  // B[key][c] = V[key][c]
      mma16816(t[0], a[kp], b[0], b[1]);
      mma16816(t[1], a[kp], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * dn][e] += t[0][e];
      o[2 * dn + 1][e] += t[1][e];
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kFT, 2) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int n) {
  using L = FlashLayout<DQK, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // 2 stages
  bf16* Vs = Ks + 2 * L::kTileK;             // 2 stages
  bf16* Qs = Ks + L::kTileK;  // K's second stage, until every warp holds its q fragments

  const int tid = threadIdx.x, r0 = (tid >> 5) * 16;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kT, tiles = (n + kT - 1) / kT;
  const bf16* kh = k + bh * n * DQK;
  const bf16* vh = v + bh * n * DV;
  auto issue = [&](int it) {
    const int st = it & 1;
    cp_rows<DQK>(Ks + st * L::kTileK, L::kLdK, kh, it * kT, kT, n, tid, kFT);
    cp_rows<DV>(Vs + st * L::kTileV, L::kLdV, vh, it * kT, kT, n, tid, kFT);
  };
  cp_rows<DQK>(Qs, L::kLdK, q + bh * n * DQK, q0, kT, n, tid, kFT);
  issue(0);
  cp_async_commit();

  uint32_t qf[DQK / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[DV / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // key tile it landed; every warp is done with the other stage
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) lda_rows(qf[kk], Qs, L::kLdK, r0, kk * 16);
      __syncthreads();  // every warp holds its q fragments: K's second stage is free
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1;
    float s[8][4];
    strip_scores<DQK>(s, qf, Ks + st * L::kTileK, L::kLdK, 4);
    if ((it + 1) * kT > n) mask_past(s, it * kT, n);
    softmax_tile<DV, kExactExp>(s, m, l, oacc);
    if (IUVL_FLASH_TILE_SUM)
      pv_tile_sum<DV>(oacc, s, Vs + st * L::kTileV, L::kLdV);
    else
      pv_tile<DV>(oacc, s, Vs + st * L::kTileV, L::kLdV, 4);
  }
  store_fwd<DV>(o + bh * n * DV, lse + bh * n, oacc, m, l, q0 + r0, n);
}

// delta[row] = sum_c do[row, c] * o[row, c] in fp32: one warp a row.
template <int kDV>
__global__ void flash_delta_kernel(const bf16* __restrict__ d_o, const bf16* __restrict__ o,
                                   float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * kDV;
  // Both 32-column halves in one expression (its FMA contraction sets the
  // rounding); a third, partial term at d_v 80.
  float s = to_f(d_o[base + lane]) * to_f(o[base + lane]) +
            to_f(d_o[base + lane + 32]) * to_f(o[base + lane + 32]);
  if (kDV > 64 && lane + 64 < kDV) s += to_f(d_o[base + lane + 64]) * to_f(o[base + lane + 64]);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// --- dq pass: a block per 64-query tile, looping over the key tiles; warp
// w owns queries q0 + 16 w .. +15 and works on the key tile in kSub pieces.
template <int DQK, int DV, int kSub>
__global__ void __launch_bounds__(kFT, 2) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int n) {
  using L = FlashLayout<DQK, DV>;
  constexpr int kPairs = kT / kSub / 16;  // 16-key pairs of 8-column tiles a piece
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::kTileK;      // 2 stages
  bf16* Vs = Ks + 2 * L::kTileK;  // 2 stages
  bf16* dOs = Vs + L::kTileV;     // V's second stage, until every warp holds its dO fragments

  const int tid = threadIdx.x, lane = tid & 31, lo = lane >> 2, r0 = (tid >> 5) * 16;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kT, tiles = (n + kT - 1) / kT;
  const bf16* kh = k + bh * n * DQK;
  const bf16* vh = v + bh * n * DV;
  auto issue = [&](int it) {
    const int st = it & 1;
    cp_rows<DQK>(Ks + st * L::kTileK, L::kLdK, kh, it * kT, kT, n, tid, kFT);
    cp_rows<DV>(Vs + st * L::kTileV, L::kLdV, vh, it * kT, kT, n, tid, kFT);
  };
  cp_rows<DQK>(Qs, L::kLdK, q + bh * n * DQK, q0, kT, n, tid, kFT);
  cp_rows<DV>(dOs, L::kLdV, d_o + bh * n * DV, q0, kT, n, tid, kFT);
  issue(0);
  cp_async_commit();
  // Each row's lse (and in log2 units) and delta; 0 past n (then q = do = 0).
  float lr[2], ll[2], dl[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + r0 + lo + 8 * u;
    lr[u] = row < n ? lse[bh * n + row] : 0.f;
    ll[u] = lr[u] * kLog2e;
    dl[u] = row < n ? delta[bh * n + row] : 0.f;
  }

  float dqa[DQK / 8][4] = {};
  uint32_t of[DV / 16][4];
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // key tile it landed; the other stage is free
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) lda_rows(of[kk], dOs, L::kLdV, r0, kk * 16);
      __syncthreads();  // every warp holds its dO fragments: V's second stage is free
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const bf16* Kt = Ks + st * L::kTileK;
    const bf16* Vt = Vs + st * L::kTileV;
    const bool tail = (it + 1) * kT > n;
#pragma unroll 1  // one piece's s and dp live at a time
    for (int sub = 0; sub < kSub; ++sub) {
      const int c0 = sub * kPairs * 16, k0 = it * kT + c0;  // the piece's first key
      float s[2 * kPairs][4] = {}, dp[2 * kPairs][4] = {};
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t qa[4];
        lda_rows(qa, Qs, L::kLdK, r0, kk * 16);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          uint32_t b[4];
          ldb_rows(b, Kt, L::kLdK, c0 + p * 16, kk * 16);  // B[d][key] = K[key][d]
          mma16816(s[2 * p], qa, b[0], b[1]);
          mma16816(s[2 * p + 1], qa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          uint32_t b[4];
          ldb_rows(b, Vt, L::kLdV, c0 + p * 16, kk * 16);  // B[c][key] = V[key][c]
          mma16816(dp[2 * p], of[kk], b[0], b[1]);
          mma16816(dp[2 * p + 1], of[kk], b[2], b[3]);
        }
      // p = exp(s - lse) (0 past n), ds = p (dp - delta), rounded to bf16
      // as the A operand of dq += ds k.
#pragma unroll
      for (int j = 0; j < 2 * kPairs; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const float p = !tail || key < n ? p_from_lse(s[j][e], lr[u], ll[u]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[u]);
        }
#pragma unroll
      for (int kq = 0; kq < kPairs; ++kq) {
        uint32_t da[4];
        acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int dn = 0; dn < DQK / 16; ++dn) {
          uint32_t b[4];
          ldb_cols(b, Kt, L::kLdK, dn * 16, c0 + kq * 16);  // B[key][c] = K[key][c]
          mma16816(dqa[2 * dn], da, b[0], b[1]);
          mma16816(dqa[2 * dn + 1], da, b[2], b[3]);
        }
      }
    }
  }
  store_strip_rows<DQK>(dq + bh * n * DQK, dqa, q0 + r0, n);
}

// --- dk/dv pass: a block per 64-key tile, looping over the query tiles;
// warp w owns keys k0 + 16 w .. +15 and works on s^T, dp^T (keys as rows),
// the query tile in kSub pieces.
template <int DQK, int DV, int kSub>
__global__ void __launch_bounds__(kFT, 2) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ d_o, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int n) {
  using L = FlashLayout<DQK, DV>;
  constexpr int kPairs = kT / kSub / 16;  // 16-query pairs of 8-column tiles a piece
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  unsigned char* stages = smem + L::kTileK * sizeof(bf16);
  auto Qs = [&](int st) { return reinterpret_cast<bf16*>(stages + st * L::kStage); };
  auto dOs = [&](int st) { return Qs(st) + L::kTileK; };
  auto LSE = [&](int st) { return reinterpret_cast<float*>(dOs(st) + L::kTileV); };
  auto DEL = [&](int st) { return LSE(st) + kT; };

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kT, tiles = (n + kT - 1) / kT;
  const bf16* qh = q + bh * n * DQK;
  const bf16* doh = d_o + bh * n * DV;
  auto issue = [&](int it) {
    const int st = it & 1;
    cp_rows<DQK>(Qs(st), L::kLdK, qh, it * kT, kT, n, tid, kFT);
    cp_rows<DV>(dOs(st), L::kLdV, doh, it * kT, kT, n, tid, kFT);
    stage_rows_f32(LSE(st), lse + bh * n, it * kT, n);
    stage_rows_f32(DEL(st), delta + bh * n, it * kT, n);
  };
  cp_rows<DQK>(Ks, L::kLdK, k + bh * n * DQK, k0, kT, n, tid, kFT);
  cp_rows<DV>(dOs(1), L::kLdV, v + bh * n * DV, k0, kT, n, tid, kFT);  // V, parked
  issue(0);
  cp_async_commit();

  float dka[DQK / 8][4] = {}, dva[DV / 8][4] = {};
  uint32_t vf[DV / 16][4];
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // query tile it landed; the other stage is free
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) lda_rows(vf[kk], dOs(1), L::kLdV, r0, kk * 16);
      __syncthreads();  // every warp holds its V fragments: dO's second stage is free
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const bf16* Qt = Qs(st);
    const bf16* dOt = dOs(st);
    const float* LSEt = LSE(st);
    const float* DELt = DEL(st);
#pragma unroll 1  // one piece's s and dp live at a time
    for (int sub = 0; sub < kSub; ++sub) {
      const int c0 = sub * kPairs * 16;  // the piece's first query in the tile
      float s[2 * kPairs][4] = {}, dp[2 * kPairs][4] = {};
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t ka[4];
        lda_rows(ka, Ks, L::kLdK, r0, kk * 16);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          uint32_t b[4];
          ldb_rows(b, Qt, L::kLdK, c0 + p * 16, kk * 16);  // B[d][query] = Q[query][d]
          mma16816(s[2 * p], ka, b[0], b[1]);
          mma16816(s[2 * p + 1], ka, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          uint32_t b[4];
          ldb_rows(b, dOt, L::kLdV, c0 + p * 16, kk * 16);  // B[c][query] = dO[query][c]
          mma16816(dp[2 * p], vf[kk], b[0], b[1]);
          mma16816(dp[2 * p + 1], vf[kk], b[2], b[3]);
        }
      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), column by column.
#pragma unroll
      for (int j = 0; j < 2 * kPairs; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = c0 + 8 * j + 2 * (lane & 3) + e2;
          const float lr = LSEt[c], ll = lr * kLog2e, dl = DELt[c];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int e = 2 * u + e2;
            const float p = p_from_lse(s[j][e], lr, ll);
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dl);
          }
        }
      // dv += bf16(p)^T do, dk += bf16(ds)^T q.
#pragma unroll
      for (int kq = 0; kq < kPairs; ++kq) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kq], s[2 * kq + 1]);
        acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int dn = 0; dn < DV / 16; ++dn) {
          uint32_t b[4];
          ldb_cols(b, dOt, L::kLdV, dn * 16, c0 + kq * 16);  // B[query][c] = dO[query][c]
          mma16816(dva[2 * dn], pa, b[0], b[1]);
          mma16816(dva[2 * dn + 1], pa, b[2], b[3]);
        }
#pragma unroll
        for (int dn = 0; dn < DQK / 16; ++dn) {
          uint32_t b[4];
          ldb_cols(b, Qt, L::kLdK, dn * 16, c0 + kq * 16);  // B[query][d] = Q[query][d]
          mma16816(dka[2 * dn], da, b[0], b[1]);
          mma16816(dka[2 * dn + 1], da, b[2], b[3]);
        }
      }
    }
  }
  store_strip_rows<DQK>(dk + bh * n * DQK, dka, k0 + r0, n);
  store_strip_rows<DV>(dv + bh * n * DV, dva, k0 + r0, n);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemBlock) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

namespace {

template <int DQK, int DV>
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int n,
              cudaStream_t s) {
  const size_t smem = FlashLayout<DQK, DV>::kFwd;
  if (int err = set_smem(flash_fwd_kernel<DQK, DV>, smem)) return err;
  flash_fwd_kernel<DQK, DV><<<dim3((n + kT - 1) / kT, bh), kFT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
              const void* d_o, void* delta, void* dq, void* dk, void* dv, int bh, int n,
              cudaStream_t s) {
  using L = FlashLayout<DQK, DV>;
  const int rows = bh * n;
  flash_delta_kernel<DV><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(d_o),
                                                        static_cast<const bf16*>(o),
                                                        static_cast<float*>(delta), rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  const dim3 grid((n + kT - 1) / kT, bh);
  auto dq_pass = flash_bwd_dq_kernel<DQK, DV, L::kDqSub>;
  if (int err = set_smem(dq_pass, L::kDq)) return err;
  dq_pass<<<grid, kFT, L::kDq, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  auto dkv = flash_bwd_dkv_kernel<DQK, DV, L::kDkvSub>;
  if (int err = set_smem(dkv, L::kDkv)) return err;
  dkv<<<grid, kFT, L::kDkv, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Call fn<DQK, DV>(args...) for the instantiated widths: d_qk a multiple of
// 32 in [128, 256], d_v 64 or 80.
#define IUVL_FLASH_DISPATCH(fn, ...)                                           \
  switch (d_qk * 1000 + d_v) {                                                \
    case 128064: return fn<128, 64>(__VA_ARGS__);                             \
    case 160064: return fn<160, 64>(__VA_ARGS__);                             \
    case 192064: return fn<192, 64>(__VA_ARGS__);                             \
    case 224064: return fn<224, 64>(__VA_ARGS__);                             \
    case 256064: return fn<256, 64>(__VA_ARGS__);                             \
    case 128080: return fn<128, 80>(__VA_ARGS__);                             \
    case 160080: return fn<160, 80>(__VA_ARGS__);                             \
    case 192080: return fn<192, 80>(__VA_ARGS__);                             \
    case 224080: return fn<224, 80>(__VA_ARGS__);                             \
    case 256080: return fn<256, 80>(__VA_ARGS__);                             \
    default: return static_cast<int>(cudaErrorInvalidValue);                  \
  }

// q, k: (BH, N, d_qk) bf16; v, o: (BH, N, d_v) bf16; lse: (BH, N) fp32;
// d_qk in {128, 160, 192, 224, 256} (zero-padded by the caller), d_v 64 or
// 80, any N; the softmax scale is folded into q by the caller.
extern "C" int iuvl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int n, int d_qk, int d_v, void* stream) {
  IUVL_FLASH_DISPATCH(flash_fwd, q, k, v, o, lse, bh, n, static_cast<cudaStream_t>(stream))
}

// The backward of iuvl_flash_fwd: do (BH, N, d_v) bf16, o and lse from the
// forward; delta (BH, N) fp32 scratch; dq, dk (BH, N, d_qk) and dv
// (BH, N, d_v) bf16.
extern "C" int iuvl_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* d_o, void* delta, void* dq, void* dk,
                              void* dv, int bh, int n, int d_qk, int d_v, void* stream) {
  IUVL_FLASH_DISPATCH(flash_bwd, q, k, v, o, lse, d_o, delta, dq, dk, dv, bh, n,
                      static_cast<cudaStream_t>(stream))
}
