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
// VMEM and built the bias with (N, N) selector matrices: at N 4096 those
// are 64 MB each, which no SM holds. The design here:
// - relh and relw first, by their own launch (rel_features_kernel): for a
//   grid line g, relh of row g (or relw of column g) is one product of the
//   line's w query rows and the table slice Rh[g] (Rw[g]), w x w x d, on
//   the tensor cores (fp32 sums), into a scratch of (BH, N, 2, w) fp32.
//   Each table slice is read once a head: built per query tile, relw would
//   read all of Rw (512 KB at w 64) through L2 a tile, and as dots on the
//   CUDA cores the pre-pass took 0.070 ms of a 0.491 ms global call (0.022
//   on the tensor cores; tools/kernel_ab.py on the card).
// - The attention keeps its scores in registers: mma.sync m16n8k16 (bf16,
//   fp32 accumulators; helpers in mma.cuh), a warp owning a 16-query strip
//   and a 64-key tile at a time, 32 fp32 scores a lane. The bias is added
//   in the accumulator layout. At w 64 (the global grid) a 64-key tile is
//   one grid row: relh[q, key / w] is one value a row a tile (read from the
//   block's relh rows in shared memory) and relw[q, key % w] is a fixed set
//   of 32 values a lane for the whole loop, held in registers. At other w
//   both come from the block's relh / relw rows in shared memory.
// - Two passes over the key tiles: JAX rounds p = bf16(exp(s -
//   m) / l) after normalising, so a one-pass online softmax is another
//   function. Pass 1 takes each row's max and sum from register scores;
//   pass 2 recomputes the same products in the same order, forms p in
//   registers (1 / l folded in as a multiply) and feeds it straight in as
//   the A operand of p v (mma.cuh acc_to_a). No score goes to shared memory.
// - Streaming grids (N > 256; the global block): a block of four warps
//   owns a 64-query tile; K (pass 1) and K, V (pass 2) tiles come by
//   cp.async into a two-stage ring, the next tile's copy in flight while
//   this one is used, one block barrier a tile.
// - Resident grids (N <= 256; the 14 x 14 windows): a block owns a whole
//   (window, head) pair: its K and V (rows padded to 16) land once by
//   cp.async, then each warp walks the pair's 16-row strips on its own
//   with no further block barrier: 300 blocks of 13 strips at ViT-B, one
//   wave, where 64-row query tiles would make 1200 blocks, a quarter of
//   them 4 rows.
// - The last tile of either side is masked (rows past N load as zero, keys
//   past N score -inf), so N need not be a multiple of 16 or 64.
// Measured (ptxas on the card, d 64; no spills): the streaming kernel at w
// 64 168 registers and 62,464 bytes of shared memory a block (the ring of
// K and V, the Q tile, the block's relh rows), so 3 blocks, 12 warps an SM
// (__launch_bounds__(128, 3)); the resident kernel 136 registers, 67,072
// bytes at N 196, 3 blocks; rel_features_kernel 54 registers, 18,432 bytes.
// On the card (H100 SXM, 700 W; PERF.md) the global call takes 0.44 ms
// against its 0.053 ms bound, 0.42 of it the attention: by count the
// ldmatrix traffic (one x4 load a pair of products with 16-row strips) and
// the exponentials of two passes come before the tensor cores; the
// windowed call 0.13 ms against a 0.009 ms bound (bytes), one wave of
// small blocks.
//
// Rounding points follow the TPU kernel: Rh and Rw are expanded in fp32 and
// rounded to bf16 by the wrapper; relh and relw are fp32 sums and stay
// fp32; the scale multiplies the fp32 scores; softmax in fp32; p rounded to
// bf16; p v summed in fp32 and rounded once.
#include "mma.cuh"

namespace iuvl {
namespace {

constexpr int kWT = 64;            // key tile; a streaming block's query tile
constexpr int kWThreads = 128;     // 4 warps, each a 16-row strip
constexpr int kResidentMax = 256;  // N up to this: one block a (window, head)

// ----------------------------------------------------- relh and relw --
// rel[bh][q][t][a]: t 0 relh (grid row g = q / w), t 1 relw (grid column g
// = q % w). Block (line group, t, bh) takes `lines` grid lines g: the
// line's w query rows (Q_g) and the table slice T[g] (w x D), rows padded
// to wp (a multiple of 16) with zeros, land in shared memory by cp.async;
// then rel rows of line g = Q_g T[g]^T, a (wp x wp x D) tensor-core product
// per line, each warp a 16-row strip at a time.
template <int D>
__global__ void __launch_bounds__(kWThreads) rel_features_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ rh, const bf16* __restrict__ rw,
    float* __restrict__ rel, int n, int w, int lines) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int wp = (w + 15) / 16 * 16, t = blockIdx.y;
  const size_t bh = blockIdx.z;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // lines x wp x kLd
  bf16* Ts = Qs + lines * wp * kLd;          // lines x wp x kLd
  const bf16* table = t ? rw : rh;
  for (int i = threadIdx.x; i < lines * wp * (D / 8); i += kWThreads) {
    const int li = i / (wp * (D / 8)), r = i / (D / 8) % wp, c = (i % (D / 8)) * 8;
    const int g = blockIdx.x * lines + li;
    const bool in = g < w && r < w;
    const int qi = in ? (t ? r * w + g : g * w + r) : 0;
    cp_async16_zfill(Qs + (li * wp + r) * kLd + c, q + (bh * n + qi) * D + c, in);
    cp_async16_zfill(Ts + (li * wp + r) * kLd + c,
                     table + (static_cast<size_t>(in ? g : 0) * w + (in ? r : 0)) * D + c, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, lo = lane >> 2;
  const int strips = wp / 16;
  for (int sidx = warp; sidx < lines * strips; sidx += kWThreads / 32) {
    const int li = sidx / strips, m0 = (sidx % strips) * 16, g = blockIdx.x * lines + li;
    if (g >= w) break;
    const bf16* Ql = Qs + li * wp * kLd;
    const bf16* Tl = Ts + li * wp * kLd;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) lda_rows(qa[kk], Ql, kLd, m0, kk * 16);
    for (int n0 = 0; n0 < wp; n0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldb_rows(b, Tl, kLd, n0, kk * 16);  // B[c][a] = T[a][c]
        mma16816(acc[0], qa[kk], b[0], b[1]);
        mma16816(acc[1], qa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = m0 + lo + 8 * ((e >> 1) & 1);
        const int a = n0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (r < w && a < w) {
          const int qi = t ? r * w + g : g * w + r;
          rel[((bh * n + qi) * 2 + t) * w + a] = acc[e >> 2][e & 3];
        }
      }
    }
  }
}

// ------------------------------------------------ per-strip helpers --
// A lane's two rows of its warp's strip: lo = lane / 4, hi = lo + 8; its
// columns of 8-column tile j: 8 j + 2 (lane % 4) + {0, 1}.

// s = (s * scale + relh[row, key / w]) + relw[row, key % w], -inf past n;
// RH, RW the strip's rows (pitch w) in shared memory.
__device__ __forceinline__ void bias_lookup(float (&s)[8][4], const float* RH, const float* RW,
                                            int k0, int n, int w, float scale) {
  const int lane = threadIdx.x & 31, lo = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * (lane & 3) + e;
      if (key >= n) {
        s[j][e] = s[j][e + 2] = kNegInf;
        continue;
      }
      const int g = key / w, c = key - g * w;
      s[j][e] = (s[j][e] * scale + RH[lo * w + g]) + RW[lo * w + c];
      s[j][e + 2] = (s[j][e + 2] * scale + RH[(lo + 8) * w + g]) + RW[(lo + 8) * w + c];
    }
  }
}

// Online max and sum of each of the lane's two rows over one tile's scores
// (the four lanes of a row reduced by shuffles).
__device__ __forceinline__ void row_stats(const float (&s)[8][4], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx), ml = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sum += ex2(fmaf(s[j][2 * h], kLog2e, -ml)) + ex2(fmaf(s[j][2 * h + 1], kLog2e, -ml));
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[h] = l[h] * ex2((m[h] - m_new) * kLog2e) + sum;
    m[h] = m_new;
  }
}

// o += bf16(exp(s - m) / l) v over keys [16 p, 16 p + 16) of the tile Vt,
// p < pairs; ml = m log2(e), il = 1 / l per row.
template <int D>
__device__ __forceinline__ void strip_pv(float (&o)[D / 8][4], const float (&s)[8][4],
                                         const float (&ml)[2], const float (&il)[2],
                                         const bf16* Vt, int ld, int pairs) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p >= pairs) break;
    float pr[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pr[u][e] = ex2(fmaf(s[2 * p + u][e], kLog2e, -ml[e >> 1])) * il[e >> 1];
    uint32_t a[4];
    acc_to_a(a, pr[0], pr[1]);
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldb_cols(b, Vt, ld, dn * 16, p * 16);
      mma16816(o[2 * dn], a, b[0], b[1]);
      mma16816(o[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------- streaming --
template <int D>
struct StreamSmem {
  static constexpr int kLd = D + 8;
  static constexpr int kTile = kWT * kLd;  // bf16 elements
  // K ring, V ring, Q tile (bf16); relh rows, and relw rows unless kW64 (fp32)
  static size_t bytes(int w, bool w64) {
    return 5 * kTile * sizeof(bf16) + (w64 ? 1 : 2) * kWT * w * sizeof(float);
  }
};

// kW64: w == 64 (a key tile is one grid row), relw held in registers.
template <int D, bool kW64>
__global__ void __launch_bounds__(kWThreads, 3) window_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ rel, bf16* __restrict__ o, int n, int w, float scale) {
  using L = StreamSmem<D>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // 2 stages
  bf16* Vs = Ks + 2 * L::kTile;              // 2 stages
  bf16* Qs = Vs + 2 * L::kTile;
  float* RH = reinterpret_cast<float*>(Qs + L::kTile);  // kWT x w
  float* RW = RH + kWT * w;                             // kWT x w (not kW64)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kWT, r0 = warp * 16;
  const bf16* kh = k + bh * n * D;
  const bf16* vh = v + bh * n * D;
  const int tiles = (n + kWT - 1) / kWT, steps = 2 * tiles;
  // Step s: pass s / tiles over key tile s % tiles (pass 2 also needs V).
  auto issue = [&](int s) {
    const int st = s & 1, k0 = (s % tiles) * kWT;
    cp_rows<D>(Ks + st * L::kTile, kLd, kh, k0, kWT, n, tid, kWThreads);
    if (s >= tiles) cp_rows<D>(Vs + st * L::kTile, kLd, vh, k0, kWT, n, tid, kWThreads);
  };
  cp_rows<D>(Qs, kLd, q + bh * n * D, q0, kWT, n, tid, kWThreads);
  issue(0);
  cp_async_commit();
  // The block's relh (and relw) rows; zero past n.
  for (int i = tid; i < kWT * w; i += kWThreads) {
    const int r = i / w, a = i % w;
    const bool in = q0 + r < n;
    const float* src = rel + ((bh * n + q0 + r) * 2) * w + a;
    RH[i] = in ? src[0] : 0.f;
    if (!kW64) RW[i] = in ? src[w] : 0.f;
  }
  const int lo = lane >> 2;
  float rwr[8][4];  // kW64: relw[row, c] of the lane's columns c, its two rows
  if (kW64) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + lo + (e >> 1) * 8, c = 8 * j + 2 * (lane & 3) + (e & 1);
        rwr[j][e] = row < n ? rel[((bh * n + row) * 2 + 1) * w + c] : 0.f;
      }
  }

  uint32_t qf[D / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ml[2], il[2];
  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s landed; every warp is done with the other stage
    if (s == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) lda_rows(qf[kk], Qs, kLd, r0, kk * 16);
    }
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    const int st = s & 1, kt = s % tiles, k0 = kt * kWT;
    float sc[8][4];
    strip_scores<D>(sc, qf, Ks + st * L::kTile, kLd, 4);
    if (kW64) {  // n = 64 * 64: no key past n
      const float rh_lo = RH[(r0 + lo) * w + kt], rh_hi = RH[(r0 + lo + 8) * w + kt];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (sc[j][e] * scale + (e < 2 ? rh_lo : rh_hi)) + rwr[j][e];
    } else {
      bias_lookup(sc, RH + r0 * w, RW + r0 * w, k0, n, w, scale);
    }
    if (s < tiles) {
      row_stats(sc, m, l);
      if (s == tiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ml[h] = m[h] * kLog2e;
          il[h] = 1.f / l[h];
        }
      }
    } else {
      strip_pv<D>(oacc, sc, ml, il, Vs + st * L::kTile, kLd, 4);
    }
  }
  store_strip_rows<D>(o + bh * n * D, oacc, q0 + r0, n);
}

// ----------------------------------------------------------- resident --
template <int D>
struct ResidentSmem {
  static constexpr int kLd = D + 8;
  // K, V (rows padded to 16), bf16; each warp's strip of relh, relw (fp32)
  static size_t bytes(int n, int w) {
    const int rows = (n + 15) / 16 * 16;
    return 2 * rows * kLd * sizeof(bf16) + 4 * 16 * 2 * w * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(kWThreads, 3) window_resident_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ rel, bf16* __restrict__ o, int n, int w, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = (n + 15) / 16 * 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + rows * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  float* RH = reinterpret_cast<float*>(Vs + rows * kLd) + warp * 32 * w;  // 16 x w
  float* RW = RH + 16 * w;                                                // 16 x w
  const size_t bh = blockIdx.x;
  const bf16* qh = q + bh * n * D;
  cp_rows<D>(Ks, kLd, k + bh * n * D, 0, rows, n, tid, kWThreads);
  cp_rows<D>(Vs, kLd, v + bh * n * D, 0, rows, n, tid, kWThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int tiles = (n + kWT - 1) / kWT;
  for (int row0 = warp * 16; row0 < n; row0 += 4 * 16) {
    __syncwarp();  // the previous strip's relh, relw are read
    for (int i = lane; i < 16 * w; i += 32) {
      const int r = i / w, a = i % w;
      const bool in = row0 + r < n;
      const float* src = rel + ((bh * n + row0 + r) * 2) * w + a;
      RH[i] = in ? src[0] : 0.f;
      RW[i] = in ? src[w] : 0.f;
    }
    uint32_t qf[D / 16][4];  // A fragments straight from device memory
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + lo + (e & 1) * 8, c = kk * 16 + 2 * (lane & 3) + (e >> 1) * 8;
        const bf16* src = qh + static_cast<size_t>(row) * D + c;
        qf[kk][e] = row < n ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      }
    __syncwarp();
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ml[2], il[2];
    for (int kt = 0; kt < tiles; ++kt) {  // pass 1
      const int k0 = kt * kWT, pairs = min(4, (rows - k0) / 16);
      float sc[8][4];
      strip_scores<D>(sc, qf, Ks + k0 * kLd, kLd, pairs);
      bias_lookup(sc, RH, RW, k0, n, w, scale);
      row_stats(sc, m, l);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[h] = m[h] * kLog2e;
      il[h] = 1.f / l[h];
    }
    float oacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {  // pass 2
      const int k0 = kt * kWT, pairs = min(4, (rows - k0) / 16);
      float sc[8][4];
      strip_scores<D>(sc, qf, Ks + k0 * kLd, kLd, pairs);
      bias_lookup(sc, RH, RW, k0, n, w, scale);
      strip_pv<D>(oacc, sc, ml, il, Vs + k0 * kLd, kLd, pairs);
    }
    store_strip_rows<D>(o + bh * n * D, oacc, row0, n);
  }
}

constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int D>
int window_forward(const void* q, const void* k, const void* v, const void* rh, const void* rw,
                   void* rel, void* o, int bh, int n, int w, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  float* relf = static_cast<float*>(rel);
  bf16* ob = static_cast<bf16*>(o);
  const int wp = (w + 15) / 16 * 16, lines = wp >= 64 ? 1 : 64 / wp;
  const size_t rel_smem = 2 * static_cast<size_t>(lines) * wp * (D + 8) * sizeof(bf16);
  if (int err = set_smem(rel_features_kernel<D>, rel_smem)) return err;
  rel_features_kernel<D><<<dim3((w + lines - 1) / lines, 2, bh), kWThreads, rel_smem, s>>>(
      qb, static_cast<const bf16*>(rh), static_cast<const bf16*>(rw), relf, n, w, lines);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (n <= kResidentMax) {
    const size_t smem = ResidentSmem<D>::bytes(n, w);
    if (int err = set_smem(window_resident_kernel<D>, smem)) return err;
    window_resident_kernel<D><<<bh, kWThreads, smem, s>>>(qb, kb, vb, relf, ob, n, w, scale);
  } else if (w == kWT) {
    const size_t smem = StreamSmem<D>::bytes(w, true);
    if (int err = set_smem(window_stream_kernel<D, true>, smem)) return err;
    window_stream_kernel<D, true><<<dim3((n + kWT - 1) / kWT, bh), kWThreads, smem, s>>>(
        qb, kb, vb, relf, ob, n, w, scale);
  } else {
    const size_t smem = StreamSmem<D>::bytes(w, false);
    if (int err = set_smem(window_stream_kernel<D, false>, smem)) return err;
    window_stream_kernel<D, false><<<dim3((n + kWT - 1) / kWT, bh), kWThreads, smem, s>>>(
        qb, kb, vb, relf, ob, n, w, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q, k, v, o: (BH, N, d) bf16, d 64 or 80; rh, rw: (w, w, d) bf16, the expanded
// tables rounded to bf16; rel: (BH, N, 2, w) fp32 scratch (relh, relw); N =
// w * w; scale = d^-1/2.
extern "C" int iuvl_window_attention(const void* q, const void* k, const void* v, const void* rh,
                                     const void* rw, void* rel, void* o, int bh, int n, int d,
                                     int w, float scale, void* stream) {
  if (w < 1 || w * w != n || bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return window_forward<64>(q, k, v, rh, rw, rel, o, bh, n, w, scale, stream);
    case 80: return window_forward<80>(q, k, v, rh, rw, rel, o, bh, n, w, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
