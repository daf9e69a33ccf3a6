// The streaming forward of rel-pos flash attention (s, p and the output
// sums in registers, K and V through a two-stage cp.async ring), shared by
// B2b / B14 (flash_attention_rowbias.cu, which says how it is designed and
// what it measures) and B2 (flash_attention.cu), whose attention is the
// same function: B2 hands the head outputs it writes to its projection.
#pragma once

#include "mma.cuh"

namespace iuvl {
namespace {

constexpr int kRT = 128;      // threads: 4 warps, each a 16-row strip
constexpr int kT = 64;        // query / key tile
constexpr int kLdP = kT + 8;  // expander rows

// RA[r][a] (pitch ka + 8) for the query rows q0 + r, r < kT: relh[row][a]
// (a < h), relw[row][a - h] (h <= a < h + w), 0 past n (the query tile's
// bias features). By cp.async when relh and relw rows are whole 16-byte
// pieces, else by plain loads; columns [h + w, ka + 8) are left as they
// are (zero_ra_pad).
__device__ __forceinline__ void stage_ra(bf16* ra, int ka, const bf16* relh, const bf16* relw,
                                         int q0, int n, int h, int w) {
  const int ld = ka + 8;
  if (h % 8 == 0 && w % 8 == 0) {
    const int ch = h / 8, cw = w / 8;
    for (int i = threadIdx.x; i < kT * (ch + cw); i += kRT) {
      const int r = i / (ch + cw), c = i % (ch + cw), row = q0 + r;
      const bool in = row < n;
      const bf16* src = c < ch ? relh + static_cast<size_t>(in ? row : 0) * h + c * 8
                               : relw + static_cast<size_t>(in ? row : 0) * w + (c - ch) * 8;
      cp_async16_zfill(ra + r * ld + c * 8, src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kT * (h + w); i += kRT) {
      const int r = i / (h + w), a = i % (h + w), row = q0 + r;
      bf16 val = to_bf(0.f);
      if (row < n) val = a < h ? relh[static_cast<size_t>(row) * h + a]
                               : relw[static_cast<size_t>(row) * w + a - h];
      ra[r * ld + a] = val;
    }
  }
}

// Columns [h + w, ka + 8) of kT rows of RA: zero.
__device__ __forceinline__ void zero_ra_pad(bf16* ra, int ka, int h, int w) {
  const int ld = ka + 8, pad = ld - (h + w);
  for (int i = threadIdx.x; i < kT * pad; i += kRT)
    ra[(i / pad) * ld + h + w + i % pad] = to_bf(0.f);
}

// E[a][c] (pitch kLdP) for the keys k0 + c of the tile: eh[a][key] (a <
// h), ew[a - h][key] (h <= a < h + w), 0 past h + w or past n; only the
// 16-row groups g with bit g of `groups` set (the rest left as they are).
// By cp.async when the expander rows are 16-byte aligned (n % 8 == 0),
// else by plain loads.
__device__ __forceinline__ void stage_e(bf16* e, int ka, const bf16* eh, const bf16* ew, int k0,
                                        int n, int h, int w, int groups = -1) {
  if (n % 8 == 0) {
    for (int i = threadIdx.x; i < ka * (kT / 8); i += kRT) {
      const int a = i / (kT / 8), c = (i % (kT / 8)) * 8, key = k0 + c;
      if (!(groups >> (a >> 4) & 1)) continue;
      const bool in = key < n && a < h + w;
      const bf16* src = a < h ? eh + static_cast<size_t>(a) * n
                              : ew + static_cast<size_t>(in ? a - h : 0) * n;
      cp_async16_zfill(e + a * kLdP + c, src + (in ? key : 0), in);
    }
  } else {
    for (int i = threadIdx.x; i < ka * kT; i += kRT) {
      const int a = i / kT, c = i % kT, key = k0 + c;
      if (!(groups >> (a >> 4) & 1)) continue;
      bf16 val = to_bf(0.f);
      if (key < n && a < h + w)
        val = a < h ? eh[static_cast<size_t>(a) * n + key]
                    : ew[static_cast<size_t>(a - h) * n + key];
      e[a * kLdP + c] = val;
    }
  }
}

// key / w for 0 <= key < 2^24, inv_w = 1 / w: a float estimate, corrected.
__device__ __forceinline__ int div_w(int key, int w, float inv_w) {
  int g = __float2int_rz((key + 0.5f) * inv_w);
  g -= g * w > key;
  g += (g + 1) * w <= key;
  return g;
}

// ------------------------------------------------------------ forward --
// One online pass over the key tiles, 64 keys a step. Scores, p and the
// output accumulators stay in registers (mma.sync m16n8k16, mma.cuh): a
// warp owns a 16-query strip, 32 fp32 scores and D / 2 fp32 output sums a
// lane; the max and sum of a row come from its four lanes by quad shuffles.
// The streaming kernel's bias: B2b at w == 64 (a key tile is one grid row:
// relw[q, key % w] fixed registers a lane, relh[q, key / w] one value a row
// a tile), B2b at other w (both read from the block's RA rows), B14 (the
// product RA E over the expander groups in use).
enum FwdBias { kBiasW64 = 0, kBiasIdx = 1, kBiasExp = 2 };

template <int D>
struct FwdSmem {
  static constexpr int kLd = D + 8;
  static constexpr size_t kTile = kT * kLd * sizeof(bf16);
  // Streaming: two stages of K and V (the Q tile lands in K's second stage
  // first), RA, and for B14 one E tile.
  static size_t stream(int ka, bool exp) {
    return 4 * kTile + kT * (ka + 8) * sizeof(bf16) + (exp ? ka * kLdP * sizeof(bf16) : 0);
  }
  // Resident: K and V (rows padded to 16); B14 the expander rows of every
  // key (pitch rows + 8), B2b each warp's strip of relh | relw rows.
  static size_t resident(int n, int h, int w, int ka, bool exp) {
    const size_t rows = (n + 15) / 16 * 16;
    return (2 * rows * kLd + (exp ? ka * (rows + 8) : 4 * 16 * (h + w))) * sizeof(bf16);
  }
};

// B2b's bias looked up: s = (s + relw[row, key % w]) + relh[row, key / w],
// as the TPU kernel sums them, -inf past n. R: the strip's first row of
// relh | relw (relh at columns [0, h), relw at [h, h + w)), pitch ld.
__device__ __forceinline__ void bias_lookup(float (&s)[8][4], const bf16* R, int ld, int k0,
                                            int n, int h, int w, float inv_w) {
  const int lane = threadIdx.x & 31, lo = lane >> 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * (lane & 3) + e;
      if (key >= n) {
        s[j][e] = s[j][e + 2] = kNegInf;
        continue;
      }
      const int g = div_w(key, w, inv_w), c = h + key - g * w;
      s[j][e] = (s[j][e] + to_f(R[lo * ld + c])) + to_f(R[lo * ld + g]);
      s[j][e + 2] = (s[j][e + 2] + to_f(R[(lo + 8) * ld + c])) + to_f(R[(lo + 8) * ld + g]);
    }
}

// --- streaming (N > 256: the global grid): a block of four warps owns a
// 64-query tile; K and V come by cp.async into a two-stage ring, the next
// tile's copy in flight while this one is used, one block barrier a tile.
// B14's E tile (only the groups in use) is one stage: its copy is issued
// after that barrier and lands while the warps compute q k^T, behind a
// second barrier (two E stages would hold the block to two an SM).
template <int D, int kBias>
__global__ void __launch_bounds__(kRT, 3) rb_fwd_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw, const bf16* __restrict__ eh,
    const bf16* __restrict__ ew, const int* __restrict__ nz, bf16* __restrict__ o,
    float* __restrict__ lse, int n, int h, int w, int ka) {
  constexpr int kLd = D + 8, kTileE = kT * kLd;
  constexpr bool kExp = kBias == kBiasExp;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // 2 stages
  bf16* Vs = Ks + 2 * kTileE;                 // 2 stages
  bf16* RA = Vs + 2 * kTileE;                 // kT x (ka + 8)
  const int lda = ka + 8;
  bf16* E = RA + kT * lda;  // B14: ka x kLdP
  bf16* Qs = Ks + kTileE;   // K's second stage, until every warp holds its q fragments

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kT, r0 = warp * 16;
  const bf16* kh = k + bh * n * D;
  const bf16* vh = v + bh * n * D;
  const int tiles = (n + kT - 1) / kT;
  auto issue = [&](int it) {
    const int st = it & 1, k0 = it * kT;
    cp_rows<D>(Ks + st * kTileE, kLd, kh, k0, kT, n, tid, kRT);
    cp_rows<D>(Vs + st * kTileE, kLd, vh, k0, kT, n, tid, kRT);
  };
  cp_rows<D>(Qs, kLd, q + bh * n * D, q0, kT, n, tid, kRT);
  if (kExp) zero_ra_pad(RA, ka, h, w);
  stage_ra(RA, ka, relh + bh * n * h, relw + bh * n * w, q0, n, h, w);
  issue(0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float rwr[kBias == kBiasW64 ? 8 : 1][4];  // w 64: relw[row, c] at the lane's columns c
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  const float inv_w = 1.f / w;

  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // key tile it landed; every warp is done with the other stage
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) lda_rows(qf[kk], Qs, kLd, r0, kk * 16);
      if constexpr (kBias == kBiasW64) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rwr[j][e] =
                to_f(RA[(r0 + lo + 8 * (e >> 1)) * lda + h + 8 * j + 2 * (lane & 3) + (e & 1)]);
      }
      __syncthreads();  // every warp holds its q fragments: K's second stage is free
    }
    const int groups = kExp ? nz[it] : 0;  // the expander groups in use
    if (kExp) {
      stage_e(E, ka, eh, ew, it * kT, n, h, w, groups);
      cp_async_commit();
    }
    if (it + 1 < tiles) issue(it + 1);
    cp_async_commit();
    const int st = it & 1, k0 = it * kT;
    float s[8][4];
    strip_scores<D>(s, qf, Ks + st * kTileE, kLd, 4);
    if constexpr (kBias == kBiasExp) {  // s += RA E over the groups in use
      cp_async_wait<1>();
      __syncthreads();  // this tile's E landed
      for (int g = 0; g < ka / 16; ++g) {
        if (!(groups >> g & 1)) continue;
        uint32_t ra[4];
        lda_rows(ra, RA, lda, r0, g * 16);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          ldb_cols(b, E, kLdP, p * 16, g * 16);  // B[a][key] = E[a][key]
          mma16816(s[2 * p], ra, b[0], b[1]);
          mma16816(s[2 * p + 1], ra, b[2], b[3]);
        }
      }
      mask_past(s, k0, n);
    } else if constexpr (kBias == kBiasW64) {  // key tile it is grid row it; n = 64 h
      const float rh0 = to_f(RA[(r0 + lo) * lda + it]), rh1 = to_f(RA[(r0 + lo + 8) * lda + it]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] + rwr[j][e]) + (e < 2 ? rh0 : rh1);
    } else {
      bias_lookup(s, RA + r0 * lda, lda, k0, n, h, w, inv_w);
    }
    softmax_tile<D>(s, m, l, oacc);
    pv_tile<D>(oacc, s, Vs + st * kTileE, kLd, 4);
  }
  store_fwd<D>(o + bh * n * D, lse + bh * n, oacc, m, l, q0 + r0, n);
}

constexpr size_t kSmemMax = 232448;  // a block's shared memory on Hopper

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace
}  // namespace iuvl
