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
//   [drelh | drelw] = ds [eh | ew]^T   (for B2b: ds summed over each key
//   row and over each key column of the grid).
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
// - Forward: one online pass over 64-key tiles with s, p and the output
//   sums in registers (mma.sync m16n8k16, mma.cuh): a warp owns a 16-query
//   strip; the max and sum of a row come from its four lanes by quad
//   shuffles; alpha rescales m, l and the output sums in registers; p is
//   packed to bf16 straight into the A operand of p v. B2b adds its bias in
//   the accumulator layout: at w 64 (a key tile is one grid row) relw is a
//   fixed set of 32 registers a lane and relh one value a row a tile; at
//   other w both are looked up in the strip's relh | relw rows in shared
//   memory. B14 adds relh eh + relw ew as one more tensor-core product over
//   the 16-row groups of the expander tile in use (5 of 8 at N 4096 with
//   one-hot expanders): rb_nz_kernel (iuvl_relpos_groups) writes those
//   groups, a word a 64-key tile, once for the forward and the backward of
//   a call, and only they are loaded.
//   * N > 256 (the global grid): a block of four warps owns a 64-query
//     tile; K and V come by cp.async into a two-stage ring, the next tile's
//     copy in flight while this one is used, one block barrier a tile.
//     B14's E tile is one stage, copied while the warps compute q k^T and
//     waited for behind a second barrier: with two, B14 ran two blocks an
//     SM and took 0.547 ms at the global shape, with one three and 0.472
//     (tools/kernel_ab.py on the card).
//   * N <= 256 (the windows), where the (window, head) pairs are at least
//     the SM count: a block owns a whole pair: its K, V (and for B14 every
//     key's expander rows) land once, then each warp walks the pair's
//     16-row strips (13 at N 196) with no further block barrier: 300
//     blocks in one wave, not 1200 query tiles, a quarter of them 4 rows.
//     B14 keeps a strip's relh | relw fragments in registers there (h + w
//     <= 64, else it streams). Fewer pairs stream as 64-query tiles.
//   Measured (ptxas on the card, d 64; no spills): the streaming kernel
//   168 registers and 54,272 bytes of shared memory a block (B2b at w 64),
//   152 and 72,704 (B14, h + w 128); the resident one 124 and 63,488 (B2b),
//   147 and 73,728 (B14) at N 196: 3 blocks, 12 warps an SM
//   (__launch_bounds__(128, 3)). On the card (H100 SXM, 700 W; PERF.md) the
//   global forward takes 0.244 ms (B2b) and 0.48 (B14, the expander product
//   5 groups of 16 deep beside q k^T's 64) against 0.052 / 0.104 ms bounds;
//   windowed 0.073 / 0.058 ms of device time.
// - Backward: two passes, as the TPU kernel's dkv and dq pallas_calls. (A
//   one-pass design that adds dq and the bias cotangents with fp32 atomics
//   runs as slow with those adds made plain stores, 12.24 against 12.49 ms
//   at the global shape, tools/kernel_ab.py on the card: its cost is the
//   scores and dp going through shared fp32 and one 126 KB block an SM, not
//   the atomics. Two passes give the same bits on every run.) Each pass
//   keeps s, dp, p and ds in registers (mma.sync m16n8k16, mma.cuh): a
//   warp owns a 16-row strip and one 64-row tile of the other side at a
//   time, p and ds packed to bf16 straight into the A operand of the next
//   product; the other side's tiles come by cp.async into a two-stage ring,
//   one block barrier a tile.
//   * dk/dv pass: a block per 64-key tile loops over the query tiles with
//     s^T and dp^T (keys as rows); dk, dv sum in registers. B14 adds e^T
//     relh^T as a product over the expander groups in use; B2b adds relw,
//     relh from the query tile's rows in shared memory.
//   * dq pass: a block per 64-query tile loops over the key tiles; dq sums
//     in registers, and so do the bias cotangents: B2b at w 64 (a key tile
//     is one grid row) keeps drelw[q, c] in registers at the lane's fixed
//     columns c and writes drelh[q, tile] as a row sum (shuffles). B14,
//     and B2b at other w (the windows; the one-hot e that the indices
//     describe, written once a call by rb_onehot_kernel), accumulate ds e^T
//     in registers for up to 8 groups of 16 (h + w <= 128; past that the
//     pass runs again for the next 8 groups, dq written once), skipping
//     the groups the expander tile leaves zero (a word a key tile from
//     rb_nz_kernel). (Sums in shared memory, the four lanes of a row in
//     turn, serialise on the CUDA cores; the products run on the tensor
//     cores, and B2b's windowed backward then costs what B14's does.)
//   Every output element is summed by one block in a fixed order and
//   written once: no atomics, no zeroed accumulators, the same bits on
//   every run. s and dp are computed in both passes: 7 N^2 d products
//   against the one pass's 5.
//   Measured (ptxas on the card, d 64, global shape; no spills): the dk/dv
//   pass 240 registers and 91,136 bytes of shared memory a block (B2b),
//   242 and 109,568 (B14); the dq pass 223 and 72,704 (B2b at w 64), 255
//   and 109,568 (B14): 2 blocks, 8 warps an SM (__launch_bounds__(128, 2)).
//   On the card (H100 SXM, 700 W; PERF.md) B2b's global backward takes
//   1.07 ms against its 0.130 ms bound: 0.66 the dk/dv pass (four products
//   a tile, each operand tile of the other side read twice by ldmatrix,
//   once as is and once transposed), 0.38 the dq pass.
//
// Rounding points follow the TPU kernels: s, the bias and the softmax in
// fp32 (B2b sums (q k + relw) + relh); the unnormalised p = exp(s - m)
// rounded to bf16 for p v, per 64-key tile; o =
// bf16(acc / l); lse = m + log(l); in the backward p = exp(s - lse) in
// fp32, ds rounded to bf16 before the products dq, dk and the bias
// cotangents, dv from bf16(p); dk, dv rounded once; dq, drelh and drelw
// summed in fp32 and rounded once to bf16 (the JAX wrappers round the fp32
// sums of their kernels to the same dtype).
#include "rowbias_fwd.cuh"

namespace iuvl {
namespace {

// lse (0 past n) and delta (0 past n) of rows [q0, q0 + kT) by cp.async.
// A row past n has q = do = 0, so dp = delta = 0 and ds = 0 whatever p is.
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int q0, int n) {
  if (threadIdx.x < kT / 4) {
    const int r = threadIdx.x * 4;
    if (q0 + r + 4 <= n && (reinterpret_cast<size_t>(src + q0 + r) & 15) == 0) {
      cp_async16_zfill(dst + r, src + q0 + r, true);
    } else {
      for (int u = 0; u < 4; ++u) dst[r + u] = q0 + r + u < n ? src[q0 + r + u] : 0.f;
    }
  }
}

// B2b's one-hot expanders, as B14 takes them: e[a][key] = 1 where key / w
// == a (a < h) or key % w == a - h (h <= a < h + w), else 0; (h + w, n) bf16.
__global__ void rb_onehot_kernel(bf16* __restrict__ e, int n, int h, int w) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(h + w) * n) return;
  const int a = static_cast<int>(i / n), key = static_cast<int>(i % n);
  e[i] = to_bf((a < h ? key / w == a : key % w == a - h) ? 1.f : 0.f);
}

// nz[t]: bit g set where rows 16 g .. 16 g + 15 of key tile t's expander
// tile hold a non-zero value (the groups the products cannot skip).
__global__ void __launch_bounds__(kRT) rb_nz_kernel(const bf16* __restrict__ eh,
                                                    const bf16* __restrict__ ew,
                                                    int* __restrict__ nz, int n, int h, int w,
                                                    int ka) {
  __shared__ int bits_s;
  if (threadIdx.x == 0) bits_s = 0;
  __syncthreads();
  const int k0 = blockIdx.x * kT;
  auto row = [&](int a) {
    return a < h ? eh + static_cast<size_t>(a) * n : ew + static_cast<size_t>(a - h) * n;
  };
  int bits = 0;
  if (n % 8 == 0) {  // 16-byte pieces; a value is non-zero where a bit but its sign is
    for (int i = threadIdx.x; i < (h + w) * (kT / 8); i += kRT) {
      const int a = i / (kT / 8), key = k0 + (i % (kT / 8)) * 8;
      if (key >= n) continue;
      const uint4 val = *reinterpret_cast<const uint4*>(row(a) + key);
      if ((val.x | val.y | val.z | val.w) & 0x7fff7fffu) bits |= 1 << (a / 16);
    }
  } else {
    for (int i = threadIdx.x; i < (h + w) * kT; i += kRT) {
      const int a = i / kT, key = k0 + i % kT;
      if (key < n && to_f(row(a)[key]) != 0.f) bits |= 1 << (a / 16);
    }
  }
  if (bits) atomicOr(&bits_s, bits);
  __syncthreads();
  if (threadIdx.x == 0) nz[blockIdx.x] = bits_s;
}

// ------------------------------------------------------------ forward --
// The streaming kernel and its helpers are in rowbias_fwd.cuh.
constexpr int kResidentMax = 256;  // N up to this: one block a (window, head)
constexpr int kResidentKa = 64;    // B14's resident kernel: h + w up to this

// Every key's expander rows for the resident kernel: e[a][key] (pitch lde)
// = eh[a][key] (a < h), ew[a - h][key] (h <= a < h + w), 0 past h + w or
// past n, for a < ka and key < rows; two keys a load where n is even.
__device__ __forceinline__ void load_e_all(bf16* e, int lde, int ka, const bf16* eh,
                                           const bf16* ew, int n, int h, int w, int rows) {
  auto src = [&](int a) {
    return a < h ? eh + static_cast<size_t>(a) * n : ew + static_cast<size_t>(a - h) * n;
  };
  if (n % 2 == 0) {
    const int half = rows / 2;
    for (int i = threadIdx.x; i < ka * half; i += kRT) {
      const int a = i / half, key = (i % half) * 2;
      const uint32_t val = key < n && a < h + w
                               ? *reinterpret_cast<const uint32_t*>(src(a) + key) : 0u;
      *reinterpret_cast<uint32_t*>(e + a * lde + key) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ka * rows; i += kRT) {
      const int a = i / rows, key = i % rows;
      e[a * lde + key] = key < n && a < h + w ? src(a)[key] : to_bf(0.f);
    }
  }
}

// --- resident (N <= 256: the 14 x 14 windows): a block owns a whole
// (window, head) pair. Its K, V (and for B14 every key's expander rows)
// land once; then each warp walks the pair's 16-row strips with no further
// block barrier, the keys in 64-key steps of the online softmax. B14 holds
// a strip's RA fragments in registers (h + w <= 64); B2b reads a strip's
// relh | relw rows from the warp's own shared rows.
template <int D, bool kExp>
__global__ void __launch_bounds__(kRT, 3) rb_fwd_resident_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, const int* __restrict__ nz, bf16* __restrict__ o,
    float* __restrict__ lse, int n, int h, int w, int ka) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = (n + 15) / 16 * 16, lde = rows + 8, hw = h + w;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + rows * kLd;
  bf16* E = Vs + rows * kLd;                   // B14: ka x lde
  bf16* R = Vs + rows * kLd + warp * 16 * hw;  // B2b: 16 x hw, the warp's own
  const size_t bh = blockIdx.x;
  const bf16* qh = q + bh * n * D;
  const bf16* rhh = relh + bh * n * h;
  const bf16* rwh = relw + bh * n * w;
  cp_rows<D>(Ks, kLd, k + bh * n * D, 0, rows, n, tid, kRT);
  cp_rows<D>(Vs, kLd, v + bh * n * D, 0, rows, n, tid, kRT);
  cp_async_commit();
  if (kExp) load_e_all(E, lde, ka, eh, ew, n, h, w, rows);
  cp_async_wait<0>();
  __syncthreads();

  const int tiles = (n + kT - 1) / kT;
  const float inv_w = 1.f / w;
  auto ra_at = [&](int row, int a) {  // RA[row][a]: relh | relw, 0 past h + w or n
    if (row >= n || a >= hw) return 0.f;
    return to_f(a < h ? rhh[static_cast<size_t>(row) * h + a]
                      : rwh[static_cast<size_t>(row) * w + a - h]);
  };
  for (int row0 = warp * 16; row0 < n; row0 += 4 * 16) {
    uint32_t qf[D / 16][4];  // A fragments straight from device memory
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + lo + (e & 1) * 8, c = kk * 16 + 2 * (lane & 3) + (e >> 1) * 8;
        qf[kk][e] = row < n ? *reinterpret_cast<const uint32_t*>(qh + static_cast<size_t>(row) *
                                                                          D + c)
                            : 0u;
      }
    uint32_t raf[kExp ? kResidentKa / 16 : 1][4];  // B14: the strip's RA fragments
    if constexpr (kExp) {
#pragma unroll
      for (int g = 0; g < kResidentKa / 16; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + lo + (e & 1) * 8, a = g * 16 + 2 * (lane & 3) + (e >> 1) * 8;
          raf[g][e] = g < ka / 16 ? pack_bf16(ra_at(row, a), ra_at(row, a + 1)) : 0u;
        }
    } else {
      __syncwarp();  // the previous strip's rows are read
      for (int i = lane; i < 16 * hw; i += 32) {
        const int r = i / hw, a = i % hw;
        R[i] = to_bf(ra_at(row0 + r, a));
      }
      __syncwarp();
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float oacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      const int k0 = kt * kT, pairs = min(4, (rows - k0) / 16);
      float s[8][4];
      strip_scores<D>(s, qf, Ks + k0 * kLd, kLd, pairs);
      if constexpr (kExp) {  // s += RA E over the groups in use
        const int groups = nz[kt];
#pragma unroll
        for (int g = 0; g < kResidentKa / 16; ++g) {
          if (!(groups >> g & 1)) continue;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p >= pairs) break;
            uint32_t b[4];
            ldb_cols(b, E, lde, k0 + p * 16, g * 16);  // B[a][key] = E[a][key]
            mma16816(s[2 * p], raf[g], b[0], b[1]);
            mma16816(s[2 * p + 1], raf[g], b[2], b[3]);
          }
        }
        mask_past(s, k0, n);
      } else {
        bias_lookup(s, R, hw, k0, n, h, w, inv_w);
      }
      softmax_tile<D>(s, m, l, oacc);
      pv_tile<D>(oacc, s, Vs + k0 * kLd, kLd, pairs);
    }
    store_fwd<D>(o + bh * n * D, lse + bh * n, oacc, m, l, row0, n);
  }
}

// ----------------------------------------------------------- backward --
// Two passes, as the TPU kernel's dq and dkv pallas_calls: a block per key
// tile for dk, dv; a block per query tile for dq and the bias cotangents.
// Each output element is summed in one block, in a fixed order, and
// written once: no atomics, no zeroed accumulators, the same bits on every
// run. Both passes compute s and dp (7 N^2 d products in all, against the
// one-pass design's 5).

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

// The dq pass's bias and bias cotangents: B2b at w == 64 (relw and the
// drelw sums in registers, drelh a row sum a key tile); B2b at other w (the
// bias read from the RA rows, the cotangents as the product ds e^T with the
// one-hot e that the indices describe, rb_onehot_kernel); B14 (both as
// products with the expander tile).
enum DrelMode { kDrelW64 = 0, kDrelIdx = 1, kDrelExp = 2 };

template <int D>
struct BwdSmem {
  static constexpr int kLd = D + 8;
  static constexpr size_t kTile = kT * kLd * sizeof(bf16);
  __host__ __device__ static size_t ra(int ka) { return kT * (ka + 8) * sizeof(bf16); }
  __host__ __device__ static size_t e(int ka) { return ka * kLdP * sizeof(bf16); }
  // dk/dv pass: K, V, E (B14), then two stages of {Q, dO, RA, lse, delta}.
  __host__ __device__ static size_t dkv_stage(int ka) {
    return 2 * kTile + ra(ka) + 2 * kT * sizeof(float);
  }
  __host__ __device__ static size_t dkv(int ka, bool exp) {
    return 2 * kTile + (exp ? e(ka) : 0) + 2 * dkv_stage(ka);
  }
  // dq pass: Q, dO, RA, then two stages of {K, V, E (not at w 64)}.
  __host__ __device__ static size_t dq_stage(int ka, bool exp) {
    return 2 * kTile + (exp ? e(ka) : 0);
  }
  __host__ __device__ static size_t dq(int ka, bool exp) {
    return 2 * kTile + ra(ka) + 2 * dq_stage(ka, exp);
  }
};

// --- dk/dv pass: a block per 64-key tile, looping over the query tiles;
// warp w owns keys k0 + 16 w .. +15 and works on s^T, dp^T (keys as rows).
template <int D, bool kExp>
__global__ void __launch_bounds__(kRT, 2) rb_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ nz, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int n, int h, int w, int ka) {
  using L = BwdSmem<D>;
  constexpr int kLd = L::kLd, kTileE = kT * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTileE;
  bf16* E = Vs + kTileE;
  unsigned char* stages = reinterpret_cast<unsigned char*>(E) + (kExp ? L::e(ka) : 0);
  const size_t stage_bytes = L::dkv_stage(ka);
  const int lda = ka + 8;
  auto Qs = [&](int st) { return reinterpret_cast<bf16*>(stages + st * stage_bytes); };
  auto dOs = [&](int st) { return Qs(st) + kTileE; };
  auto RA = [&](int st) { return dOs(st) + kTileE; };
  auto LSE = [&](int st) { return reinterpret_cast<float*>(RA(st) + kT * lda); };
  auto DEL = [&](int st) { return LSE(st) + kT; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * kT, r0 = warp * 16;
  const bf16* qh = q + bh * n * D;
  const bf16* doh = d_o + bh * n * D;
  const bf16* rhh = relh + bh * n * h;
  const bf16* rwh = relw + bh * n * w;
  const int tiles = (n + kT - 1) / kT;
  auto issue = [&](int it) {
    const int st = it & 1, q0 = it * kT;
    cp_rows<D>(Qs(st), kLd, qh, q0, kT, n, tid, kRT);
    cp_rows<D>(dOs(st), kLd, doh, q0, kT, n, tid, kRT);
    stage_ra(RA(st), ka, rhh, rwh, q0, n, h, w);
    stage_rows_f32(LSE(st), lse + bh * n, q0, n);
    stage_rows_f32(DEL(st), delta + bh * n, q0, n);
  };
  cp_rows<D>(Ks, kLd, k + bh * n * D, k0, kT, n, tid, kRT);
  cp_rows<D>(Vs, kLd, v + bh * n * D, k0, kT, n, tid, kRT);
  if (kExp) stage_e(E, ka, eh, ew, k0, n, h, w);
  zero_ra_pad(RA(0), ka, h, w);
  zero_ra_pad(RA(1), ka, h, w);
  issue(0);
  cp_async_commit();
  const int groups = kExp ? nz[blockIdx.x] : 0;
  // B2b: the grid row and column of the lane's two keys (0 past n).
  int kg[2] = {0, 0}, kc[2] = {0, 0};
  if (!kExp) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int key = k0 + r0 + lo + 8 * u;
      if (key < n) {
        kg[u] = key / w;
        kc[u] = key - kg[u] * w;
      }
    }
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  uint32_t kf[D / 16][4], vf[D / 16][4];

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // query tile it landed; the other stage is free
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        lda_rows(kf[kk], Ks, kLd, r0, kk * 16);
        lda_rows(vf[kk], Vs, kLd, r0, kk * 16);
      }
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1;
    const bf16* Qt = Qs(st);
    const bf16* dOt = dOs(st);
    const bf16* RAt = RA(st);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldb_rows(b, Qt, kLd, p * 16, kk * 16);  // B[d][query] = Q[query][d]
        mma16816(s[2 * p], kf[kk], b[0], b[1]);
        mma16816(s[2 * p + 1], kf[kk], b[2], b[3]);
        ldb_rows(b, dOt, kLd, p * 16, kk * 16);
        mma16816(dp[2 * p], vf[kk], b[0], b[1]);
        mma16816(dp[2 * p + 1], vf[kk], b[2], b[3]);
      }
    }
    if (kExp) {  // s^T += E^T RA^T over the groups in use
      for (int g = 0; g < ka / 16; ++g) {
        if (!(groups >> g & 1)) continue;
        uint32_t ea[4];
        lda_cols(ea, E, kLdP, r0, g * 16);  // A[key][a] = E[a][key]
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldb_rows(b, RAt, lda, p * 16, g * 16);  // B[a][query] = RA[query][a]
          mma16816(s[2 * p], ea, b[0], b[1]);
          mma16816(s[2 * p + 1], ea, b[2], b[3]);
        }
      }
    }
    // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), column by column.
    const float* LSEt = LSE(st);
    const float* DELt = DEL(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = 8 * j + 2 * (lane & 3) + e2;
        const float ll = LSEt[c] * kLog2e, dl = DELt[c];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 2 * u + e2;
          float x = s[j][e];
          if (!kExp)  // (q.k + relw) + relh, as the TPU kernel sums them
            x = (x + to_f(RAt[c * lda + h + kc[u]])) + to_f(RAt[c * lda + kg[u]]);
          const float p = ex2(fmaf(x, kLog2e, -ll));
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl);
        }
      }
    }
    // dv += bf16(p)^T do, dk += bf16(ds)^T q.
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kq], s[2 * kq + 1]);
      acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldb_cols(b, dOt, kLd, dn * 16, kq * 16);  // B[query][c] = dO[query][c]
        mma16816(dva[2 * dn], pa, b[0], b[1]);
        mma16816(dva[2 * dn + 1], pa, b[2], b[3]);
        ldb_cols(b, Qt, kLd, dn * 16, kq * 16);
        mma16816(dka[2 * dn], da, b[0], b[1]);
        mma16816(dka[2 * dn + 1], da, b[2], b[3]);
      }
    }
  }
  store_strip_rows<D>(dk + bh * n * D, dka, k0 + r0, n);
  store_strip_rows<D>(dv + bh * n * D, dva, k0 + r0, n);
}

// --- dq pass: a block per 64-query tile, looping over the key tiles; warp
// w owns queries q0 + 16 w .. +15. Writes dq and, for the groups [g0, g0 +
// kG) (kDrelExp) or all of them, drelh and drelw; dq only when g0 == 0.
template <int D, int kMode, int kG>
__global__ void __launch_bounds__(kRT, 2) rb_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, const bf16* __restrict__ d_o, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ nz, bf16* __restrict__ dq,
    bf16* __restrict__ drelh, bf16* __restrict__ drelw, int n, int h, int w, int ka, int g0) {
  constexpr bool kE = kMode != kDrelW64;  // an E tile in each stage
  using L = BwdSmem<D>;
  constexpr int kLd = L::kLd, kTileE = kT * kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTileE;
  bf16* RA = dOs + kTileE;
  const int lda = ka + 8;
  unsigned char* stages = reinterpret_cast<unsigned char*>(RA + kT * lda);
  const size_t stage_bytes = L::dq_stage(ka, kE);
  auto Ks = [&](int st) { return reinterpret_cast<bf16*>(stages + st * stage_bytes); };
  auto Vs = [&](int st) { return Ks(st) + kTileE; };
  auto Es = [&](int st) { return Vs(st) + kTileE; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kT, r0 = warp * 16;
  const bf16* kh = k + bh * n * D;
  const bf16* vh = v + bh * n * D;
  const int tiles = (n + kT - 1) / kT;
  auto issue = [&](int it) {
    const int st = it & 1, k0 = it * kT;
    cp_rows<D>(Ks(st), kLd, kh, k0, kT, n, tid, kRT);
    cp_rows<D>(Vs(st), kLd, vh, k0, kT, n, tid, kRT);
    if constexpr (kE) stage_e(Es(st), ka, eh, ew, k0, n, h, w);
  };
  zero_ra_pad(RA, ka, h, w);
  cp_rows<D>(Qs, kLd, q + bh * n * D, q0, kT, n, tid, kRT);
  cp_rows<D>(dOs, kLd, d_o + bh * n * D, q0, kT, n, tid, kRT);
  stage_ra(RA, ka, relh + bh * n * h, relw + bh * n * w, q0, n, h, w);
  issue(0);
  cp_async_commit();
  // Each row's lse (log2 units) and delta; 0 past n (then q = do = 0).
  float ll[2], dl[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = q0 + r0 + lo + 8 * u;
    ll[u] = row < n ? lse[bh * n + row] * kLog2e : 0.f;
    dl[u] = row < n ? delta[bh * n + row] : 0.f;
  }
  const float inv_w = 1.f / w;

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  // kDrelW64: relw[row, c] of the lane's columns c, and drelw's sums there;
  // otherwise the sums of ds e^T for groups g0 .. g0 + kG - 1.
  constexpr int kR = kMode == kDrelW64 ? 8 : 2 * kG;
  float rwr[kMode == kDrelW64 ? 8 : 1][4], dra[kR][4];
#pragma unroll
  for (int j = 0; j < kR; ++j) dra[j][0] = dra[j][1] = dra[j][2] = dra[j][3] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // key tile it landed; the other stage is free
    if constexpr (kMode == kDrelW64) if (it == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rwr[j][e] =
              to_f(RA[(r0 + lo + 8 * (e >> 1)) * lda + h + 8 * j + 2 * (lane & 3) + (e & 1)]);
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1, k0 = it * kT;
    const bf16* Kt = Ks(st);
    const bf16* Vt = Vs(st);
    const bf16* Et = Es(st);
    const int groups = kE ? nz[it] : 0;  // the groups of E in use
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      lda_rows(qa, Qs, kLd, r0, kk * 16);
      lda_rows(oa, dOs, kLd, r0, kk * 16);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];
        ldb_rows(b, Kt, kLd, p * 16, kk * 16);  // B[d][key] = K[key][d]
        mma16816(s[2 * p], qa, b[0], b[1]);
        mma16816(s[2 * p + 1], qa, b[2], b[3]);
        ldb_rows(b, Vt, kLd, p * 16, kk * 16);
        mma16816(dp[2 * p], oa, b[0], b[1]);
        mma16816(dp[2 * p + 1], oa, b[2], b[3]);
      }
    }
    if constexpr (kMode == kDrelExp) {  // s += RA E over the groups in use
      for (int g = 0; g < ka / 16; ++g) {
        if (!(groups >> g & 1)) continue;
        uint32_t ra[4];
        lda_rows(ra, RA, lda, r0, g * 16);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldb_cols(b, Et, kLdP, p * 16, g * 16);  // B[a][key] = E[a][key]
          mma16816(s[2 * p], ra, b[0], b[1]);
          mma16816(s[2 * p + 1], ra, b[2], b[3]);
        }
      }
    }
    float rh[2] = {0.f, 0.f};
    if constexpr (kMode == kDrelW64) {  // key tile it is grid row it
#pragma unroll
      for (int u = 0; u < 2; ++u) rh[u] = to_f(RA[(r0 + lo + 8 * u) * lda + it]);
    }
    // p = exp(s - lse) (0 past n), ds = p (dp - delta) rounded to bf16.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        float x = s[j][e];
        if constexpr (kMode == kDrelW64) {
          x = (x + rwr[j][e]) + rh[u];
        } else if constexpr (kMode == kDrelIdx) {
          if (key < n) {  // (q.k + relw) + relh, as the TPU kernel sums them
            const int g = div_w(key, w, inv_w), row = r0 + lo + 8 * u;
            x = (x + to_f(RA[row * lda + h + key - g * w])) + to_f(RA[row * lda + g]);
          }
        }
        const float p = key < n ? ex2(fmaf(x, kLog2e, -ll[u])) : 0.f;
        dp[j][e] = round_bf(p * (dp[j][e] - dl[u]));
      }
    uint32_t da[4][4];
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) acc_to_a(da[kq], dp[2 * kq], dp[2 * kq + 1]);
    // dq += ds k
    if (g0 == 0) {
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldb_cols(b, Kt, kLd, dn * 16, kq * 16);  // B[key][c] = K[key][c]
          mma16816(dqa[2 * dn], da[kq], b[0], b[1]);
          mma16816(dqa[2 * dn + 1], da[kq], b[2], b[3]);
        }
    }
    if constexpr (kMode == kDrelW64) {
      // drelw[row, c] += ds[row, c]; drelh[row, it] = sum_c ds[row, c].
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dra[j][e] += dp[j][e];
          rs[e >> 1] += dp[j][e];
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 1);
        rs[u] += __shfl_xor_sync(0xffffffffu, rs[u], 2);
        const int row = q0 + r0 + lo + 8 * u;
        if ((lane & 3) == 0 && row < n) drelh[(bh * n + row) * h + it] = to_bf(rs[u]);
      }
    } else {
      // [drelh | drelw] += ds E^T over the groups in use.
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const int g = g0 + gi;
        if (g >= ka / 16 || !(groups >> g & 1)) continue;
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          uint32_t b[4];
          ldb_rows(b, Et, kLdP, g * 16, kq * 16);  // B[key][a] = E[a][key]
          mma16816(dra[2 * gi], da[kq], b[0], b[1]);
          mma16816(dra[2 * gi + 1], da[kq], b[2], b[3]);
        }
      }
    }
  }
  if (g0 == 0) store_strip_rows<D>(dq + bh * n * D, dqa, q0 + r0, n);
  // The bias cotangents, rounded once.
  if constexpr (kMode == kDrelW64) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + r0 + lo + 8 * u, c = 8 * j + 2 * (lane & 3);
        if (row < n)
          *reinterpret_cast<uint32_t*>(drelw + (bh * n + row) * w + c) =
              pack_bf16(dra[j][2 * u], dra[j][2 * u + 1]);
      }
  } else {
#pragma unroll
    for (int gi = 0; gi < kG; ++gi)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + r0 + lo + 8 * (e >> 1);
          const int a = (g0 + gi) * 16 + 8 * t + 2 * (lane & 3) + (e & 1);
          if (row >= n || a >= h + w) continue;
          if (a < h) drelh[(bh * n + row) * h + a] = to_bf(dra[2 * gi + t][e]);
          else drelw[(bh * n + row) * w + a - h] = to_bf(dra[2 * gi + t][e]);
        }
  }
}


// The card's SM count (the current device's, read once).
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int D, int kBias>
int launch_stream(const void* q, const void* k, const void* v, const void* relh,
                  const void* relw, const void* eh, const void* ew, const int* nz, void* o,
                  void* lse, int bh, int n, int h, int w, int ka, cudaStream_t s) {
  const size_t smem = FwdSmem<D>::stream(ka, kBias == kBiasExp);
  if (int err = set_smem(rb_fwd_stream_kernel<D, kBias>, smem)) return err;
  rb_fwd_stream_kernel<D, kBias><<<dim3((n + kT - 1) / kT, bh), kRT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(relh), static_cast<const bf16*>(relw),
      static_cast<const bf16*>(eh), static_cast<const bf16*>(ew), nz, static_cast<bf16*>(o),
      static_cast<float*>(lse), n, h, w, ka);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kExp>
int rb_forward(const void* q, const void* k, const void* v, const void* relh, const void* relw,
               const void* eh, const void* ew, void* nz, void* o, void* lse, int bh, int n,
               int h, int w, void* stream) {
  const int ka = (h + w + 15) / 16 * 16;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* groups = static_cast<const int*>(nz);
  // Resident where the pairs fill the card (a block an SM or more); fewer
  // run faster as 64-query tiles. (tools/kernel_ab.py builds a copy with
  // IUVL_RB_FWD_NO_RESIDENT to time the streaming kernel on the windows.)
  const size_t smem = FwdSmem<D>::resident(n, h, w, ka, kExp);
#ifndef IUVL_RB_FWD_NO_RESIDENT
  if (n <= kResidentMax && (!kExp || ka <= kResidentKa) && smem <= kSmemMax &&
      bh >= sm_count()) {
    if (int err = set_smem(rb_fwd_resident_kernel<D, kExp>, smem)) return err;
    rb_fwd_resident_kernel<D, kExp><<<bh, kRT, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(relh), static_cast<const bf16*>(relw),
        static_cast<const bf16*>(eh), static_cast<const bf16*>(ew), groups,
        static_cast<bf16*>(o), static_cast<float*>(lse), n, h, w, ka);
    return static_cast<int>(cudaGetLastError());
  }
#endif
  if (kExp) return launch_stream<D, kBiasExp>(q, k, v, relh, relw, eh, ew, groups, o, lse, bh, n,
                                              h, w, ka, s);
  if (w == kT) return launch_stream<D, kBiasW64>(q, k, v, relh, relw, eh, ew, groups, o, lse,
                                                 bh, n, h, w, ka, s);
  return launch_stream<D, kBiasIdx>(q, k, v, relh, relw, eh, ew, groups, o, lse, bh, n, h, w,
                                    ka, s);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *relh, *relw, *eh, *ew, *d_o;
  const float *lse, *delta;
  const int* nz;
  bf16 *dq, *drelh, *drelw;
  int n, h, w, ka;
};

template <int D, int kMode, int kG>
int launch_dq(const BwdArgs& a, int bh, int g0, cudaStream_t s) {
  const size_t smem = BwdSmem<D>::dq(a.ka, kMode != kDrelW64);
  if (int err = set_smem(rb_bwd_dq_kernel<D, kMode, kG>, smem)) return err;
  rb_bwd_dq_kernel<D, kMode, kG><<<dim3((a.n + kT - 1) / kT, bh), kRT, smem, s>>>(
      a.q, a.k, a.v, a.relh, a.relw, a.eh, a.ew, a.d_o, a.lse, a.delta, a.nz, a.dq, a.drelh,
      a.drelw, a.n, a.h, a.w, a.ka, g0);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kExp>
int rb_backward(const void* q, const void* k, const void* v, const void* relh, const void* relw,
                const void* eh, const void* ew, const void* o, const void* lse, const void* d_o,
                void* delta, void* onehot, void* nz, void* dq, void* drelh, void* drelw,
                void* dk, void* dv, int bh, int n, int h, int w, void* stream) {
  const int ka = (h + w + 15) / 16 * 16;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = bh * n, tiles = (n + kT - 1) / kT;
  rb_delta_kernel<D><<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(d_o),
                                                     static_cast<const bf16*>(o),
                                                     static_cast<float*>(delta), rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (!kExp && w != kT) {  // B2b's dq pass takes the one-hot expanders from onehot
    rb_onehot_kernel<<<static_cast<int>((static_cast<size_t>(h + w) * n + 255) / 256), 256, 0,
                       s>>>(static_cast<bf16*>(onehot), n, h, w);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
    eh = onehot;
    ew = static_cast<const bf16*>(onehot) + static_cast<size_t>(h) * n;
    rb_nz_kernel<<<tiles, kRT, 0, s>>>(static_cast<const bf16*>(eh), static_cast<const bf16*>(ew),
                                       static_cast<int*>(nz), n, h, w, ka);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  const BwdArgs a{static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v),     static_cast<const bf16*>(relh),
                  static_cast<const bf16*>(relw),  static_cast<const bf16*>(eh),
                  static_cast<const bf16*>(ew),    static_cast<const bf16*>(d_o),
                  static_cast<const float*>(lse),  static_cast<const float*>(delta),
                  static_cast<const int*>(nz),     static_cast<bf16*>(dq),
                  static_cast<bf16*>(drelh),       static_cast<bf16*>(drelw),
                  n, h, w, ka};
  const size_t smem = BwdSmem<D>::dkv(ka, kExp);
  if (int err = set_smem(rb_bwd_dkv_kernel<D, kExp>, smem)) return err;
  rb_bwd_dkv_kernel<D, kExp><<<dim3(tiles, bh), kRT, smem, s>>>(
      a.q, a.k, a.v, a.relh, a.relw, a.eh, a.ew, a.d_o, a.lse, a.delta, a.nz,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, h, w, ka);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (!kExp && w == kT) return launch_dq<D, kDrelW64, 1>(a, bh, 0, s);
  constexpr int kMode = kExp ? kDrelExp : kDrelIdx;
  if (ka <= 32) return launch_dq<D, kMode, 2>(a, bh, 0, s);
  for (int g0 = 0; g0 < ka / 16; g0 += 8)  // 8 groups of sums in registers a launch
    if (int err = launch_dq<D, kMode, 8>(a, bh, g0, s)) return err;
  return 0;
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
  IUVL_RB_DISPATCH(rb_forward, false, q, k, v, relh, relw, nullptr, nullptr, nullptr, o, lse,
                   bh, n, h, w, stream)
}

// B14's expander groups in use, once a call for its forward and backward:
// nz (int32, one word a 64-key tile) bit g where rows 16 g .. 16 g + 15 of
// [eh ; ew] hold a non-zero value in the tile's keys.
extern "C" int iuvl_relpos_groups(const void* eh, const void* ew, void* nz, int n, int h,
                                  int w, void* stream) {
  const int ka = (h + w + 15) / 16 * 16;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  rb_nz_kernel<<<(n + kT - 1) / kT, kRT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(eh), static_cast<const bf16*>(ew), static_cast<int*>(nz), n, h,
      w, ka);
  return static_cast<int>(cudaGetLastError());
}

// B14's forward also takes nz, the group words iuvl_relpos_groups wrote.
extern "C" int iuvl_relpos_fwd(const void* q, const void* k, const void* v, const void* relh,
                               const void* relw, const void* eh, const void* ew, void* nz,
                               void* o, void* lse, int bh, int n, int d, int h, int w,
                               void* stream) {
  IUVL_RB_DISPATCH(rb_forward, true, q, k, v, relh, relw, eh, ew, nz, o, lse, bh, n, h, w,
                   stream)
}

// The backward: o and lse from the forward, do (BH, N, d) bf16; scratch:
// delta (BH, N) fp32, and for B2b onehot ((h + w) N bf16, used where w !=
// 64) and nz int32 (one word a 64-key tile; B14 takes the words
// iuvl_relpos_groups wrote); outputs dq, dk, dv (BH, N, d), drelh
// (BH, N, h), drelw (BH, N, w), bf16, each written once (no zeroing needed).
extern "C" int iuvl_rowbias_bwd(const void* q, const void* k, const void* v, const void* relh,
                                const void* relw, const void* o, const void* lse,
                                const void* d_o, void* delta, void* onehot, void* nz, void* dq,
                                void* drelh, void* drelw, void* dk, void* dv, int bh, int n,
                                int d, int h, int w, void* stream) {
  if (h * w != n) return static_cast<int>(cudaErrorInvalidValue);
  IUVL_RB_DISPATCH(rb_backward, false, q, k, v, relh, relw, nullptr, nullptr, o, lse, d_o,
                   delta, onehot, nz, dq, drelh, drelw, dk, dv, bh, n, h, w, stream)
}

extern "C" int iuvl_relpos_bwd(const void* q, const void* k, const void* v, const void* relh,
                               const void* relw, const void* eh, const void* ew, const void* o,
                               const void* lse, const void* d_o, void* delta, void* nz, void* dq,
                               void* drelh, void* drelw, void* dk, void* dv, int bh, int n, int d,
                               int h, int w, void* stream) {
  IUVL_RB_DISPATCH(rb_backward, true, q, k, v, relh, relw, eh, ew, o, lse, d_o, delta, nullptr,
                   nz, dq, drelh, drelw, dk, dv, bh, n, h, w, stream)
}
