// The SAM two-way transformer's two cross attentions over the per-prompt
// image keys (B, N, C), each one pass over the keys:
//
// - t2i_stream_kernel (token -> image; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:t2i_stream): per key tile,
//   kp = x @ Wk^T + pe_wk + bk and vp = x @ Wv^T + bv, then an online
//   softmax over the image axis for every (token, head) row of the prompt's
//   pre-scaled queries. Writes only the (B, T, I) head-merged output.
// - i2t_block_kernel (image -> token; replaces
//   iuvl_tpu/ops/pallas/twoway_attention.py:i2t_block_step): per strip of
//   image rows, qp = x @ Wq^T + pe_wq + bq, attention over the prompt's T
//   tokens per head, out-projection, residual and the block's LayerNorm.
//   Reads keys once and writes the updated keys once.
//
// Bound on the card, SAM's decoder (C 256, I 128, 8 heads of 16, T tokens:
// 7 for a one-point prompt), a chunk of B = 256 prompts over N = 4096
// image tokens: each kernel does 2*B*N*C*I*2 = 137 GFLOP of projections
// (0.14 ms on the tensor cores) against 537 MB (t2i: one read, 0.16 ms) or
// 1.07 GB (i2t: read + write, 0.32 ms) of keys; the attention itself (T = 7
// tokens) is 1/16 of that. So both are bound by their bytes; with batch-1
// keys (the decoder's block 0: every prompt shares the image embedding) t2i
// reads 2 MB and projects them once (its bound is a few microseconds, the
// attention's operations), and i2t is bound by writing its (B, N, C)
// output, 0.16 ms.
//
// t2i (any T >= 1: a click loop's 20 points make 26 tokens). A head is a
// 16-wide slice (the TPU kernels' block-diagonal head packing, made for the
// MXU's 128-lane matmuls, is not carried over): warp w of a block attends
// head w, its scores 16 token rows x 16 dims against 64 keys in mma.sync
// tiles. What bounds the work is the per-prompt projection of every key
// row and the read of the keys, so:
// - The key axis is split over work items (prompt, key range), enough of
//   them to fill the card twice (the wrapper's t2i_plan picks the split),
//   so 8 prompts fill 132 SMs as 256 do. Persistent blocks, one an SM,
//   stage [Wk; Wv] (128 KB) once and walk a contiguous run of items; 64-key
//   tiles stream in by cp.async through a two-slot ring.
// - The two warpgroups project a tile with wgmma (wgmma.cuh), kp and vp
//   (m64n128k16 each, 16 steps, B read from shared memory once for the 64
//   keys, sums in registers), round and add PE and biases there, and write
//   the tile's [kp | vp] once in bf16 (a padded 64 x 256 tile). Warps then
//   read their head's kp and vp by ldmatrix (vp transposed). (A wgmma
//   accumulator gives a warp 16 keys of every head; attending from it
//   directly would keep each warp's softmax state for all 8 heads, 96
//   registers a 16-token tile, which 64 tokens cannot afford.)
// - A prompt's token tiles (up to four, 64 tokens: a pass) are all served
//   from one projection of each key tile; their online softmax state (m, l
//   and the output sums of each row) stays in registers. Prompts past 64
//   tokens take more passes; prompts of at most 8 tokens (a one-point
//   prompt has 7) skip the softmax of the 16-row tile's padding rows.
// - Each item writes its partial (o, m, l) to an fp32 scratch; a second
//   kernel merges the ranges in key order and writes bf16(o / l). No
//   atomics: two launches give the same bits.
// - Batch-1 keys: a pre-pass projects the N image rows once into a bf16
//   (N, 256) scratch (2 MB, L2-resident), and each tile of it, copied in
//   once, serves a group of prompts (4 at T <= 16).
// C5: any N >= 1. The last key tile is masked: its rows past N load as
// zeros, their scores are -inf, and nothing is written for them.
//
// i2t (any T >= 1) runs one persistent block an SM that stages Wq and Wo
// (137 KB) once and walks a contiguous range of (row group, prompt) work
// items; each warp owns a 16-row strip of the group, and the strips stream
// through one cp.async slot a warp (the next strip's load issued as soon as
// the strip is read out, the other warps' products covering it). A warp
// keeps the whole step in registers with mma.sync m16n8k16 (mma.cuh): qp
// (16 x 128, fp32 sums, rounded there and packed into the A fragments of
// the 8 heads), the scores of each head against the prompt's tokens (fp32,
// masked past T), the softmax (expf, p normalised, rounded to bf16 as the A
// operand of p v), the head outputs (the A fragments of the out-projection)
// and the out-projection in four quarters of 64 columns; the residual rows
// go to the strip's slot in bf16 (the values the LayerNorm reads), and the
// LayerNorm writes each output row once in 16-byte stores. A prompt's k and
// v (T padded to 16 rows, the rest zero) sit in shared memory in a ring of
// two stages for T <= 16 (the next prompt's fetched while this one's run),
// one above; the block turns the ring over when its prompt changes
// (work items are prompt-major, so once a prompt's groups are done). With
// batch-1 keys the items are group-major instead: a strip's qp is computed
// once and kept in registers for the prompts that follow, Wq is staged only
// for that, and its region holds the warps' residual rows meanwhile, so the
// x strips stay put across the prompts. C5: any N >= 1; the last strip's
// rows past N are zero-filled in the copy, read the last row's PE and are
// not written. C8: past 64 tokens the prompt's k and v pass through one
// 64-row stage a tile at a time, twice an item: first kp alone, for each
// row's max and sum of exp over all T tokens (fp32, rescaled online from
// tile to tile), then kp and vp, for p = exp(s - m) / l, rounded to bf16,
// and p v summed in fp32 registers across the tiles. The scores are
// computed twice; up to 64 tokens nothing changes (a template parameter).
//
// Rounding points follow the TPU kernels: products accumulate in fp32 and
// are rounded to bf16, then each bias or PE term is added and rounded in
// turn; scores and softmax in fp32; probabilities rounded to bf16 before
// p @ v; the online softmax rounds the unnormalised p per 64-key tile (as
// t2i_stream does per its tile); LayerNorm in fp32 with the two-pass
// variance.
//
// Both kernels live in this header so that B16 (decode_chunk.cu) runs them
// as its row passes: B5 with the prompt's token slots at a stride and its
// residual added before the out-projection's bias (the rounding order of
// decode_tail), B4 as it is. twoway_attention.cu holds B4's and B5's C
// entries.
#pragma once

#include "wgmma.cuh"

namespace iuvl {
namespace {
namespace twoway {

constexpr int kC = 256;      // embedding width
constexpr int kI = 128;      // attention width (C / 2)
constexpr int kHd = 16;      // head dim (8 heads)
constexpr int kLdC = kC + 8; // padded bf16 rows of C columns
constexpr int kLdI = kI + 8; // padded bf16 rows of I columns

// 8 bf16 values in one 16-byte register group.
__device__ __forceinline__ float at8(const uint4& v, int j) {
  return to_f(reinterpret_cast<const bf16*>(&v)[j]);
}
__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
// bf16(bf16(bf16(a, b) + c) + d) for a pair: a product's two sums rounded
// to bf16, then two terms added and rounded in turn (the TPU rounding).
__device__ __forceinline__ uint32_t add2_round(float a, float b, uint32_t c, uint32_t d) {
  return u32(__hadd2(__hadd2(__floats2bfloat162_rn(a, b), bf2(c)), bf2(d)));
}

// ---------------------------------------------------------------- t2i --
constexpr int kKT = 64;             // keys a tile: one wgmma's M
constexpr int kLdKV = 2 * kI + 8;   // padded bf16 rows of [kp | vp]
constexpr int kT2iThreads = 256;    // two warpgroups; warp w attends head w
constexpr int kTokGroup = 64;       // tokens a pass (four 16-row tiles)
constexpr size_t kT2iW = size_t{2 * kI} * kC * 2;      // [Wk; Wv], core-matrix layout
constexpr size_t kT2iX = size_t{kKT} * kC * 2;         // an x tile, core-matrix layout
constexpr size_t kT2iKV = size_t{kKT} * kLdKV * 2;     // a [kp | vp] tile
constexpr size_t kT2iProjSmem = kT2iW + 2 * kT2iX + kT2iKV;
constexpr size_t kT2iAttSmem = 2 * kT2iKV;
static_assert(kT2iThreads / 32 == kI / kHd, "t2i gives each warp one head");

// Prompts a work item serves from one [kp | vp] tile with batch-1 keys
// (their online-softmax state is in registers: ntt * prompts <= 4); the
// wrapper's t2i_plan mirrors this.
__host__ __device__ constexpr int t2i_group(int ntt) { return ntt == 1 ? 4 : ntt == 2 ? 2 : 1; }

// The `rows` rows of a (rows, C) weight into the core-matrix layout (the
// thread order of t2i_stage_x).
__device__ __forceinline__ void t2i_stage_w(bf16* sW, const bf16* w, int rows) {
  for (int i = threadIdx.x; i < rows * (kC / 8); i += blockDim.x) {
    const int r = (i & 7) + 8 * (i >> 8), c = ((i >> 3) & 31) * 8;
    cp_async16(sW + cm_index<kC>(r, c), w + r * kC + c);
  }
}

// Rows [k0, k0 + 64) of a (n, C) key matrix into a core-matrix x tile by
// cp.async, rows past n zero. Eight neighbouring threads fill one 128-byte
// core matrix (no bank conflicts); a warp reads 64 bytes of 8 rows.
__device__ __forceinline__ void t2i_stage_x(bf16* sX, const bf16* x, int k0, int n) {
  for (int i = threadIdx.x; i < kKT * (kC / 8); i += blockDim.x) {
    const int r = (i & 7) + 8 * (i >> 8), c = ((i >> 3) & 31) * 8;
    const bool in = k0 + r < n;
    cp_async16_zfill(sX + cm_index<kC>(r, c), x + static_cast<size_t>(in ? k0 + r : 0) * kC + c,
                     in);
  }
}

// A warpgroup's half of a tile's projection, issued (not waited for): acc
// = x W^T with W the 128 rows of Wk or Wv at sW, 16 steps of m64n128k16
// from shared memory.
__device__ __forceinline__ void t2i_project(float (&acc)[64], const bf16* sX, const bf16* sW) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wg_fence_acc(acc);
  wg_fence();
  const uint64_t dx = wg_desc<kC>(sX), dw = wg_desc<kC>(sW);
#pragma unroll
  for (int s = 0; s < kC / 16; ++s) wgmma_ss_n128(acc, dx + 16 * s, dw + 16 * s, 1);
  wg_commit();
}

// The projection's PE terms for the lane's rows (keys k0 + row, row + 8 of
// its warp's 16) and columns 8 j + q2, +1 of kp: pe[j][u] (zero past n).
__device__ __forceinline__ void t2i_load_pe(uint32_t (&pe)[16][2], const bf16* pe_wk, int k0,
                                            int n) {
  const int lane = threadIdx.x & 31, row = k0 + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      pe[j][u] = row + 8 * u < n ? __ldg(reinterpret_cast<const uint32_t*>(
                                       pe_wk + static_cast<size_t>(row + 8 * u) * kI + 8 * j +
                                       2 * (lane & 3)))
                                 : 0u;
}

// The projection's epilogue: kp = bf16(bf16(bf16(x Wk^T) + pe) + bk) (wg
// 0) or vp = bf16(bf16(x Wv^T) + bv) (wg 1) into rows of dst (pitch ld;
// the tile's row r at dst + r * ld), rows at or past `rows` dropped. bias:
// the lane's 16 column pairs of bk or bv.
__device__ __forceinline__ void t2i_epilogue(bf16* dst, int ld, const float (&acc)[64],
                                             const uint32_t (&pe)[16][2],
                                             const uint32_t (&bias)[16], int wg, int rows) {
  const int lane = threadIdx.x & 31, q2 = 2 * (lane & 3);
  const int r = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (r + 8 * u >= rows) continue;
    bf16* o = dst + static_cast<size_t>(r + 8 * u) * ld + wg * kI + q2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float a = acc[4 * j + 2 * u], b = acc[4 * j + 2 * u + 1];
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          wg == 0 ? add2_round(a, b, pe[j][u], bias[j])
                  : u32(__hadd2(__floats2bfloat162_rn(a, b), bf2(bias[j])));
    }
  }
}

// Batch-1 keys (block 0): [kp | vp] of the N image rows, once, into a
// (N, 256) bf16 scratch: a warpgroup a (64-key tile, kp or vp) with its
// half of the weights (blockIdx.y: 0 kp, 1 vp).
__global__ void __launch_bounds__(128) t2i_project_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ pe_wk, const bf16* __restrict__ wk,
    const bf16* __restrict__ bk, const bf16* __restrict__ wv, const bf16* __restrict__ bv,
    bf16* __restrict__ kpv, int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sX = reinterpret_cast<bf16*>(smem + kT2iW / 2);
  const int wg = blockIdx.y, q2 = 2 * (threadIdx.x & 3), k0 = blockIdx.x * kKT;
  t2i_stage_w(sW, wg == 0 ? wk : wv, kI);
  t2i_stage_x(sX, keys, k0, n);
  cp_async_commit();
  uint32_t bias[16], pe[16][2] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    bias[j] = __ldg(reinterpret_cast<const uint32_t*>((wg == 0 ? bk : bv) + 8 * j + q2));
  if (wg == 0) t2i_load_pe(pe, pe_wk, k0, n);
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float acc[64];
  t2i_project(acc, sX, sW);
  wg_wait<0>();
  wg_fence_acc(acc);
  t2i_epilogue(kpv + static_cast<size_t>(k0) * 2 * kI, 2 * kI, acc, pe, bias, wg, n - k0);
}

// Token -> image attention over key ranges. Work items (prompt group pg of
// G prompts, token group tg of up to 64 tokens, key range r of `splits`),
// a contiguous run of them a persistent block. kProject (per-prompt keys,
// G 1): each 64-key tile of the range is copied in (two-slot cp.async
// ring), projected by the two warpgroups (kp | vp) and its epilogue written
// to the [kp | vp] tile; else (batch-1 keys) the tile comes ready from the
// pre-pass's scratch (two-slot ring) and serves the item's G prompts. Warp
// w attends head w: for each prompt and 16-token tile, its scores against
// the tile's 64 keys, the online softmax (m, l, o in registers) and p v,
// with ldmatrix from the tile. At its last tile an item writes its partial
// (o, m, l) per (prompt, token, head) to the fp32 scratch; t2i_merge_kernel
// combines the ranges.
template <int NTT, int G, bool kProject, int kRows>
__global__ void __launch_bounds__(kT2iThreads, 1) t2i_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ src, const bf16* __restrict__ pe_wk,
    const bf16* __restrict__ wk, const bf16* __restrict__ bk, const bf16* __restrict__ wv,
    const bf16* __restrict__ bv, float* __restrict__ part_o, float* __restrict__ part_ml,
    int batch, int n, int tokens, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sX = reinterpret_cast<bf16*>(smem + kT2iW);  // kProject: two x slots
  bf16* sKV = reinterpret_cast<bf16*>(smem + (kProject ? kT2iW + 2 * kT2iX : 0));
  const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);

  const int tiles = (n + kKT - 1) / kKT, len = (tiles + splits - 1) / splits;
  const int tgroups = (tokens + kTokGroup - 1) / kTokGroup;
  const int total = (batch + G - 1) / G * tgroups * splits;
  const int i0 = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
  if (i0 >= i1) return;
  auto first = [&](int i) { return (i % splits) * len; };
  auto last = [&](int i) { return min(tiles, (i % splits + 1) * len); };
  auto prompt0 = [&](int i) { return i / (tgroups * splits) * G; };
  // (item, tile) steps in order: the one after (i, k).
  auto advance = [&](int& i, int& k) {
    if (++k == last(i) && ++i < i1) k = first(i);
  };
  auto stage = [&](int slot, int i, int k) {
    if constexpr (kProject)
      t2i_stage_x(sX + slot * (kT2iX / 2), src + static_cast<size_t>(prompt0(i)) * n * kC,
                  k * kKT, n);
    else
      cp_rows<2 * kI>(sKV + slot * (kT2iKV / 2), kLdKV, src, k * kKT, kKT, n, threadIdx.x,
                      kT2iThreads);
  };

  int it = i0, kt = first(i0), pf_i = i0, pf_k = kt, slot = 0;
  uint32_t bias[16], pe[16][2] = {};
  if constexpr (kProject) {
    t2i_stage_w(sW, wk, kI);
    t2i_stage_w(sW + kI * kC, wv, kI);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bias[j] = __ldg(reinterpret_cast<const uint32_t*>((wg == 0 ? bk : bv) + 8 * j + q2));
  }
  for (int s = 0; s < (kProject ? 2 : 1); ++s) {  // the ring's first tiles
    if (pf_i < i1) {
      stage(s, pf_i, pf_k);
      advance(pf_i, pf_k);
    }
    cp_async_commit();
  }

  uint32_t qf[G][NTT][1][4];
  float m[G][NTT][2], l[G][NTT][2], o[G][NTT][2][4];
  bool fresh = true;
  while (it < i1) {
    if constexpr (kProject) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();  // tile kt has landed; every warp is done with the last tile
    const int p0 = prompt0(it), tok0 = (it / splits) % tgroups * kTokGroup;
    if (fresh) {  // a new item: its queries (A fragments of head `warp`), state
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int tt = 0; tt < NTT; ++tt) {
          const int p = p0 + gi;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tok = tok0 + 16 * tt + g8 + 8 * (e & 1), col = warp * kHd + 8 * (e >> 1) + q2;
            qf[gi][tt][0][e] = p < batch && tok < tokens
                                   ? __ldg(reinterpret_cast<const uint32_t*>(
                                         q + (static_cast<size_t>(p) * tokens + tok) * kI + col))
                                   : 0u;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            m[gi][tt][u] = kNegInf;
            l[gi][tt][u] = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) o[gi][tt][u][j] = o[gi][tt][u][j + 2] = 0.f;
          }
        }
      fresh = false;
    }
    const bf16* kv = sKV;
    if constexpr (kProject) {
      float acc[64];
      t2i_project(acc, sX + slot * (kT2iX / 2), sW + wg * kI * kC);
      if (wg == 0) t2i_load_pe(pe, pe_wk, kt * kKT, n);
      wg_wait<0>();
      wg_fence_acc(acc);
      t2i_epilogue(sKV, kLdKV, acc, pe, bias, wg, kKT);
      __syncthreads();  // [kp | vp] is written; every product has read the x slot
      if (pf_i < i1) {
        stage(slot, pf_i, pf_k);
        advance(pf_i, pf_k);
      }
      cp_async_commit();
    } else {
      kv = sKV + slot * (kT2iKV / 2);
      if (pf_i < i1) {  // the other slot's last reader finished before the barrier
        stage(slot ^ 1, pf_i, pf_k);
        advance(pf_i, pf_k);
      }
      cp_async_commit();
    }
    const int k0 = kt * kKT;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int tt = 0; tt < NTT; ++tt) {
        float s[8][4];
        strip_scores<kHd>(s, qf[gi][tt], kv + warp * kHd, kLdKV, 4);
        if (k0 + kKT > n) mask_past(s, k0, n);
        softmax_tile<kHd, false, kRows>(s, m[gi][tt], l[gi][tt], o[gi][tt]);
        pv_tile<kHd>(o[gi][tt], s, kv + kI + warp * kHd, kLdKV, 4);
      }
    const int done = it;
    advance(it, kt);
    slot ^= 1;
    if (it != done) {  // the item's partial: o (unnormalised), m, l
      const int r = done % splits;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int tt = 0; tt < NTT; ++tt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int p = p0 + gi, tok = tok0 + 16 * tt + g8 + 8 * u;
            if (p >= batch || tok >= tokens) continue;
            const size_t row = (static_cast<size_t>(p) * splits + r) * tokens + tok;
#pragma unroll
            for (int j = 0; j < 2; ++j)
              *reinterpret_cast<float2*>(part_o + row * kI + warp * kHd + 8 * j + q2) =
                  make_float2(o[gi][tt][j][2 * u], o[gi][tt][j][2 * u + 1]);
            if ((lane & 3) == 0)
              *reinterpret_cast<float2*>(part_ml + (row * (kI / kHd) + warp) * 2) =
                  make_float2(m[gi][tt][u], l[gi][tt][u]);
          }
      fresh = true;
    }
  }
}

// out[p, t, 16 h + 8 half ..] = bf16(sum_r o_r e^(m_r - M) / sum_r l_r
// e^(m_r - M)) over the key ranges r in order (M their largest m): a thread
// a (prompt, token, head, half).
__global__ void t2i_merge_kernel(const float* __restrict__ part_o,
                                 const float* __restrict__ part_ml, bf16* __restrict__ out,
                                 int batch, int tokens, int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * tokens * 16) return;
  const int half = idx & 1, h = (idx >> 1) & 7, row = idx >> 4;  // row = p * tokens + t
  const int p = row / tokens, t = row % tokens;
  float mx = kNegInf;
  for (int r = 0; r < splits; ++r)
    mx = fmaxf(mx, part_ml[(((static_cast<size_t>(p) * splits + r) * tokens + t) * 8 + h) * 2]);
  float den = 0.f, acc[8] = {};
  for (int r = 0; r < splits; ++r) {
    const size_t pr = (static_cast<size_t>(p) * splits + r) * tokens + t;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + (pr * 8 + h) * 2);
    const float w = expf(ml.x - mx);
    den += ml.y * w;
    const float4* src = reinterpret_cast<const float4*>(part_o + pr * kI + h * kHd + 8 * half);
    const float4 a = src[0], b = src[1];
    acc[0] += a.x * w, acc[1] += a.y * w, acc[2] += a.z * w, acc[3] += a.w * w;
    acc[4] += b.x * w, acc[5] += b.y * w, acc[6] += b.z * w, acc[7] += b.w * w;
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  uint4 packed;
  uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(acc[2 * j] * inv, acc[2 * j + 1] * inv);
  *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * kI + h * kHd + 8 * half) = packed;
}

template <int NTT, int G, bool kProject, int kRows = 2>
int t2i_launch(int grid, size_t smem, cudaStream_t stream, const bf16* q, const bf16* src,
               const bf16* pe_wk, const bf16* wk, const bf16* bk, const bf16* wv, const bf16* bv,
               float* part_o, float* part_ml, int batch, int n, int tokens, int splits) {
  auto kernel = t2i_stream_kernel<NTT, G, kProject, kRows>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kT2iThreads, smem, stream>>>(q, src, pe_wk, wk, bk, wv, bv, part_o, part_ml,
                                              batch, n, tokens, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- i2t --
// Persistent blocks of nw warps (8, or 7 for T > 48: shared memory), one
// block an SM. Shared memory: region A (Wq, or with batch-1 keys the
// warps' y strips), Wo, bq and bo, the token k / v ring (two stages of T
// padded to 16 rows for T <= 16, else one) and one 16-row x strip a warp.
constexpr int kKvTile = 64;                              // tokens a k / v stage holds
constexpr int kStrip = 16;                               // image rows a warp's strip
constexpr size_t kRegionA = size_t{kI} * kLdC * 2;       // Wq; batch-1: y strips
constexpr size_t kRegionB = size_t{kC} * kLdI * 2;       // Wo
constexpr size_t kParams = (kI + kC) * 2;                // bq, bo
constexpr size_t kSlot = size_t{kStrip} * kLdC * 2;      // a warp's x strip
static_assert(kWarps * kSlot <= kRegionA, "batch-1 y strips fit region A");

// qa[h] = the A fragments of qp = bf16(bf16(bf16(x Wq^T) + pe) + bq) for
// head h of the warp's 16 rows (x: the strip in shared memory; pe: the
// strip's first row of pe_wq; rows past `valid`, the masked last strip's,
// read the last valid row's pe: finite, and never written). Products in
// fp32 registers, rounded there.
__device__ __forceinline__ void i2t_qp(uint32_t (&qa)[8][4], const bf16* X, const bf16* sWq,
                                       const bf16* pe, const bf16* sbq, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q2 = 2 * (lane & 3);
  const bf16* pe_g = pe + min(g, valid - 1) * kI + q2;
  const bf16* pe_g8 = pe + min(g + 8, valid - 1) * kI + q2;
  uint32_t pe_lo[16], pe_hi[16];  // issued ahead of the products
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pe_lo[j] = __ldg(reinterpret_cast<const unsigned*>(pe_g + 8 * j));
    pe_hi[j] = __ldg(reinterpret_cast<const unsigned*>(pe_g8 + 8 * j));
  }
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < kC / 16; ++kk) {
    uint32_t a[4];
    lda_rows(a, X, kLdC, 0, kk * 16);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      uint32_t b[4];
      ldb_rows(b, sWq, kLdC, np * 16, kk * 16);  // B[k][n] = Wq[n][k]
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 8; ++h)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = 2 * h + u;
      const uint32_t bq2 = *reinterpret_cast<const uint32_t*>(sbq + 8 * j + q2);
      qa[h][2 * u] = add2_round(acc[j][0], acc[j][1], pe_lo[j], bq2);
      qa[h][2 * u + 1] = add2_round(acc[j][2], acc[j][3], pe_hi[j], bq2);
    }
}

// att[h] = the A fragments of bf16(softmax(qp_h kp_h^T * scale) v_h) over
// the prompt's T tokens (NP pairs of 8-token tiles, the tokens past T
// masked; kp, vp in shared memory, the rows past T zero): scores, softmax
// (fp32, expf, p normalised and rounded to bf16) and p v in registers.
template <int NP>
__device__ __forceinline__ void i2t_attend(uint32_t (&att)[8][4], const uint32_t (&qa)[8][4],
                                           const bf16* sKp, const bf16* sVp, int tokens,
                                           float scale) {
  const int lane = threadIdx.x & 31, q2 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float s[2 * NP][4];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t b[4];
      ldb_rows(b, sKp, kLdI, p * 16, h * 16);  // B[k][t] = kp[t][16 h + k]
      mma16816(s[2 * p], qa[h], b[0], b[1]);
      mma16816(s[2 * p + 1], qa[h], b[2], b[3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // the lane's rows g (u = 0) and g + 8
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) {
          const float v = 8 * j + q2 + (e & 1) < tokens ? s[j][e] * scale : kNegInf;
          s[j][e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j) {
        if (8 * j >= tokens) {  // a tile wholly past T: p = 0
          s[j][2 * u] = s[j][2 * u + 1] = 0.f;
          continue;
        }
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) {
          s[j][e] = expf(s[j][e] - mx);
          den += s[j][e];
        }
      }
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const float inv = 1.f / den;
#pragma unroll
      for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
        for (int e = 2 * u; e < 2 * u + 2; ++e) s[j][e] *= inv;
    }
    float o[2][4] = {};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t a[4], b[4];
      acc_to_a(a, s[2 * p], s[2 * p + 1]);      // p rounded to bf16
      ldb_cols(b, sVp, kLdI, h * 16, p * 16);  // B[t][c] = vp[t][16 h + c]
      mma16816(o[0], a, b[0], b[1]);
      mma16816(o[1], a, b[2], b[3]);
    }
    acc_to_a(att[h], o[0], o[1]);
  }
}

// Scores of head h for the warp's 16 rows against a 64-token tile (kp in
// shared memory), scaled, the tokens at or past `valid` at kNegInf.
__device__ __forceinline__ void i2t_tile_scores(float (&s)[8][4], const uint32_t (&qa)[4],
                                                const bf16* sKp, int h, int valid,
                                                float scale) {
  const int q2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    uint32_t b[4];
    ldb_rows(b, sKp, kLdI, p * 16, h * 16);  // B[k][t] = kp[t][16 h + k]
    mma16816(s[2 * p], qa, b[0], b[1]);
    mma16816(s[2 * p + 1], qa, b[2], b[3]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 8 * j + q2 + (e & 1) < valid ? s[j][e] * scale : kNegInf;
}

// T > 64, the first pass over a tile of `valid` tokens: each head's and lane
// row's (g, g + 8) running max m and sum l of exp(s - m), rescaled to the
// new max tile by tile.
__device__ __forceinline__ void i2t_tile_stats(float (&m)[8][2], float (&l)[8][2],
                                               const uint32_t (&qa)[8][4], const bf16* sKp,
                                               int valid, float scale) {
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float s[8][4];
    i2t_tile_scores(s, qa[h], sKp, h, valid, scale);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float mx = m[h][u];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * u], s[j][2 * u + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j][2 * u] - mx) + expf(s[j][2 * u + 1] - mx);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h][u] = l[h][u] * expf(m[h][u] - mx) + sum;
      m[h][u] = mx;
    }
  }
}

// T > 64, the second pass over the tile: p = exp(s - m) * inv (inv = 1 / l
// of the first pass) rounded to bf16, and o[h] += p v_h in fp32 registers.
__device__ __forceinline__ void i2t_tile_pv(float (&o)[8][2][4], const float (&m)[8][2],
                                            const float (&inv)[8][2], const uint32_t (&qa)[8][4],
                                            const bf16* sKp, const bf16* sVp, int valid,
                                            float scale) {
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float s[8][4];
    i2t_tile_scores(s, qa[h], sKp, h, valid, scale);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[h][e >> 1]) * inv[h][e >> 1];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t a[4], b[4];
      acc_to_a(a, s[2 * p], s[2 * p + 1]);      // p rounded to bf16
      ldb_cols(b, sVp, kLdI, h * 16, p * 16);  // B[t][c] = vp[t][16 h + c]
      mma16816(o[h][0], a, b[0], b[1]);
      mma16816(o[h][1], a, b[2], b[3]);
    }
  }
}

// Y = bf16(X + bf16(bf16(att Wo^T) + bo)) for the warp's 16 rows, in four
// quarters of 64 columns (fp32 sums in registers), written to the y strip
// in shared memory (X's own place with per-prompt keys: each lane writes
// the elements it read). kResFirst: Y = bf16(bf16(X + bf16(att Wo^T)) +
// bo), the residual before the bias (decode_tail's order).
template <bool kResFirst>
__device__ __forceinline__ void i2t_out(const uint32_t (&att)[8][4], const bf16* X, bf16* Y,
                                        const bf16* sWo, const bf16* sbo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll 1
  for (int c0 = 0; c0 < kC; c0 += 64) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int h = 0; h < 8; ++h)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldb_rows(b, sWo, kLdI, c0 + np * 16, h * 16);  // B[k][n] = Wo[n][k]
        mma16816(acc[2 * np], att[h], b[0], b[1]);
        mma16816(acc[2 * np + 1], att[h], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + q2;
      const uint32_t bo2 = *reinterpret_cast<const uint32_t*>(sbo + c);
      const uint32_t x_lo = *reinterpret_cast<const uint32_t*>(X + g * kLdC + c);
      const uint32_t x_hi = *reinterpret_cast<const uint32_t*>(X + (g + 8) * kLdC + c);
      const __nv_bfloat162 p_lo = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      const __nv_bfloat162 p_hi = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      *reinterpret_cast<uint32_t*>(Y + g * kLdC + c) =
          kResFirst ? u32(__hadd2(__hadd2(bf2(x_lo), p_lo), bf2(bo2)))
                    : u32(__hadd2(bf2(x_lo), __hadd2(p_lo, bf2(bo2))));
      *reinterpret_cast<uint32_t*>(Y + (g + 8) * kLdC + c) =
          kResFirst ? u32(__hadd2(__hadd2(bf2(x_hi), p_hi), bf2(bo2)))
                    : u32(__hadd2(bf2(x_hi), __hadd2(p_hi, bf2(bo2))));
    }
  }
}

// LayerNorm (fp32, two-pass variance) of the y strip's rows into out (the
// strip's first output row): two rows at a time, 16 lanes a row, a lane 8
// columns in each half; each of the first `valid` rows written once, in
// 16-byte stores (every lane runs all 8 pairs: the shuffles take the whole
// warp).
__device__ __forceinline__ void i2t_norm(bf16* out, const bf16* Y, const float* ln_w,
                                         const float* ln_b, float eps, int valid) {
  const int lane = threadIdx.x & 31, c = 8 * (lane & 15);
  float w[16], bias[16];  // the lane's columns' LayerNorm parameters
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = (k >> 1) * 128 + c + 4 * (k & 1);
    const float4 wv = __ldg(reinterpret_cast<const float4*>(ln_w + at));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(ln_b + at));
    w[4 * k] = wv.x, w[4 * k + 1] = wv.y, w[4 * k + 2] = wv.z, w[4 * k + 3] = wv.w;
    bias[4 * k] = bv.x, bias[4 * k + 1] = bv.y, bias[4 * k + 2] = bv.z, bias[4 * k + 3] = bv.w;
  }
#pragma unroll 4
  for (int r = lane >> 4; r < kStrip; r += 2) {
    float v[16];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint4 raw = *reinterpret_cast<const uint4*>(Y + r * kLdC + hf * 128 + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[8 * hf + j] = at8(raw, j);
    }
    float mean = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) mean += v[j];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mean += __shfl_xor_sync(0xffffffffu, mean, o);
    mean /= kC;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) sq += (v[j] - mean) * (v[j] - mean);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / kC + eps);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint4 packed;
      bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = 8 * hf + j;
        ov[j] = to_bf((v[k] - mean) * rstd * w[k] + bias[k]);
      }
      if (r < valid)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * kC + hf * 128 + c) = packed;
    }
  }
}

// kTail: N is no multiple of 16, so the last strip is masked (C5); without
// it every strip is full and the masks fold away at compile time.
// kResFirst: i2t_out's rounding order. A prompt's k and v rows start
// kv_stride elements after the previous prompt's (tokens * 128 for B5;
// B16 hands its Tp-slot buffers, t_valid tokens of them read). kTiled: T >
// 64, the tokens pass through a one-tile stage twice an item (C8).
template <bool kTail, bool kResFirst, bool kTiled>
__global__ void __launch_bounds__(kThreads, 1) i2t_block_kernel(
    const bf16* __restrict__ keys, const bf16* __restrict__ pe_wq, const bf16* __restrict__ kp,
    const bf16* __restrict__ vp, const bf16* __restrict__ wq, const bf16* __restrict__ bq,
    const bf16* __restrict__ wo, const bf16* __restrict__ bo, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bf16* __restrict__ out, int batch, int n, int tokens,
    int kv_stride, int shared_keys, float scale, float eps, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x >> 5, nt = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tpad = kTiled ? kKvTile : (tokens + 15) / 16 * 16, np = tpad / 16;
  bf16* sA = reinterpret_cast<bf16*>(smem);  // Wq, or batch-1's y strips
  bf16* sWo = sA + kI * kLdC;
  bf16* sbq = sWo + kC * kLdI;
  bf16* sbo = sbq + kI;
  bf16* sKV = sbo + kC;  // stage s: kp rows, then vp rows (tpad each)
  bf16* X = sKV + stages * 2 * tpad * kLdI + warp * kStrip * kLdC;
  bf16* Y = shared_keys ? sA + warp * kStrip * kLdC : X;

  // Work items (row group g of nw strips, prompt p), a contiguous range a
  // block: prompt-major with per-prompt keys (the token ring turns over
  // once a prompt's groups are done), group-major with batch-1 keys (qp of
  // a strip is computed once for the prompts that follow).
  const int strips = (n + kStrip - 1) / kStrip, groups = (strips + nw - 1) / nw;
  const int total = batch * groups;
  const int i0 = static_cast<int>(static_cast<long long>(total) * blockIdx.x / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x);
  auto prompt_of = [&](int i) { return shared_keys ? i % batch : i / groups; };
  auto group_of = [&](int i) { return shared_keys ? i / batch : i % groups; };
  // The first item past i with another prompt (i1 if none).
  auto next_prompt = [&](int i) {
    return shared_keys ? i + 1 : min(i1, (i / groups + 1) * groups);
  };
  auto stage_kv = [&](int slot, int p) {  // rows past T are zero-filled
    bf16* d = sKV + slot * 2 * tpad * kLdI;
    const size_t g0 = static_cast<size_t>(p) * kv_stride;
    cp_rows<kI>(d, kLdI, kp + g0, 0, tpad, tokens, tid, nt);
    cp_rows<kI>(d + tpad * kLdI, kLdI, vp + g0, 0, tpad, tokens, tid, nt);
  };
  // kTiled: tile k of prompt p's kp (and vp) rows into the one stage.
  auto stage_tile = [&](int p, int k, bool with_v) {
    const size_t g0 = static_cast<size_t>(p) * kv_stride;
    cp_rows<kI>(sKV, kLdI, kp + g0, k * kKvTile, kKvTile, tokens, tid, nt);
    if (with_v)
      cp_rows<kI>(sKV + kKvTile * kLdI, kLdI, vp + g0, k * kKvTile, kKvTile, tokens, tid, nt);
  };
  // Rows of strip s (the last strip's rows past n are zero-filled and
  // never written).
  auto rows_of = [&](int s) { return kTail ? min(kStrip, n - s * kStrip) : kStrip; };
  auto stage_x = [&](int i) {  // the warp's strip of item i, if it has one
    const int s = group_of(i) * nw + warp;
    const size_t row0 = static_cast<size_t>(shared_keys ? 0 : prompt_of(i)) * n + s * kStrip;
    if (s < strips) cp_rows<kC>(X, kLdC, keys + row0 * kC, 0, kStrip, rows_of(s), lane, 32);
  };
  if (i0 >= i1) return;

  if (!shared_keys) cp_rows<kC>(sA, kLdC, wq, 0, kI, kI, tid, nt);
  cp_rows<kI>(sWo, kLdI, wo, 0, kC, kC, tid, nt);
  cp_rows<kI>(sbq, kI, bq, 0, 1, 1, tid, nt);
  cp_rows<kC>(sbo, kC, bo, 0, 1, 1, tid, nt);
  int slot = 0, cur_p = prompt_of(i0);
  if (!kTiled) stage_kv(0, cur_p);
  if (!shared_keys) stage_x(i0);
  cp_async_commit();
  if (stages == 2 && next_prompt(i0) < i1) {
    stage_kv(1, prompt_of(next_prompt(i0)));
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[8][4], att[8][4];
  int cur_g = -1;
  for (int i = i0; i < i1; ++i) {
    const int p = prompt_of(i), g = group_of(i), s = g * nw + warp;
    cp_async_wait<0>();  // this item's x strip; a prefetched token stage
    if (!kTiled && p != cur_p) {  // the token ring turns over (block-uniform)
      if (stages == 2) {
        __syncthreads();  // the prefetched stage has landed everywhere; the old one is free
        slot ^= 1;
        if (next_prompt(i) < i1) {
          stage_kv(slot ^ 1, prompt_of(next_prompt(i)));
          cp_async_commit();
        }
      } else {
        __syncthreads();  // every warp is done with the one stage
        stage_kv(0, p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      cur_p = p;
    }
    if (shared_keys && g != cur_g) {  // batch-1 keys: a new group's x and qp
      __syncthreads();  // region A's y strips are read out
      cp_rows<kC>(sA, kLdC, wq, 0, kI, kI, tid, nt);
      stage_x(i);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (s < strips)
        i2t_qp(qa, X, sA, pe_wq + static_cast<size_t>(s) * kStrip * kI, sbq, rows_of(s));
      __syncthreads();  // Wq is read out: region A holds y strips again
      cur_g = g;
    }
    __syncwarp();
    if constexpr (kTiled) {
      float m[8][2], l[8][2], o[8][2][4];
#pragma unroll
      for (int h = 0; h < 8; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          m[h][u] = kNegInf;
          l[h][u] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[h][u][e] = 0.f;
        }
      if (s < strips && !shared_keys)
        i2t_qp(qa, X, sA, pe_wq + static_cast<size_t>(s) * kStrip * kI, sbq, rows_of(s));
      const int tiles = (tokens + kKvTile - 1) / kKvTile;
      for (int pass = 0; pass < 2; ++pass) {
        for (int k = 0; k < tiles; ++k) {
          __syncthreads();  // every warp is done with the stage
          stage_tile(p, k, pass == 1);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          if (s < strips) {
            const int valid = min(kKvTile, tokens - k * kKvTile);
            if (pass == 0) i2t_tile_stats(m, l, qa, sKV, valid, scale);
            else i2t_tile_pv(o, m, l, qa, sKV, sKV + kKvTile * kLdI, valid, scale);
          }
        }
        if (pass == 0)
#pragma unroll
          for (int h = 0; h < 8; ++h) l[h][0] = 1.f / l[h][0], l[h][1] = 1.f / l[h][1];
      }
      if (s < strips) {
#pragma unroll
        for (int h = 0; h < 8; ++h) acc_to_a(att[h], o[h][0], o[h][1]);
        i2t_out<kResFirst>(att, X, Y, sWo, sbo);
        __syncwarp();
        i2t_norm(out + (static_cast<size_t>(p) * n + s * kStrip) * kC, Y, ln_w, ln_b, eps,
                 rows_of(s));
        __syncwarp();
      }
    } else if (s < strips) {
      const bf16* sKp = sKV + slot * 2 * tpad * kLdI;
      const bf16* sVp = sKp + tpad * kLdI;
      if (!shared_keys)
        i2t_qp(qa, X, sA, pe_wq + static_cast<size_t>(s) * kStrip * kI, sbq, rows_of(s));
      switch (np) {
        case 1: i2t_attend<1>(att, qa, sKp, sVp, tokens, scale); break;
        case 2: i2t_attend<2>(att, qa, sKp, sVp, tokens, scale); break;
        case 3: i2t_attend<3>(att, qa, sKp, sVp, tokens, scale); break;
        default: i2t_attend<4>(att, qa, sKp, sVp, tokens, scale); break;
      }
      i2t_out<kResFirst>(att, X, Y, sWo, sbo);
      __syncwarp();
      i2t_norm(out + (static_cast<size_t>(p) * n + s * kStrip) * kC, Y, ln_w, ln_b, eps,
               rows_of(s));
      __syncwarp();  // the strip is read out before the next one lands there
    }
    if (!shared_keys && i + 1 < i1) {
      stage_x(i + 1);
      cp_async_commit();
    }
  }
}


// The body of iuvl_t2i_stream (its contract there), on stream st.
inline int t2i_stream_run(const bf16* qb, const bf16* keys, const bf16* pe, const bf16* wkb,
                          const bf16* bkb, const bf16* wvb, const bf16* bvb, bf16* out, bf16* kpv,
                          float* po, float* pml, int batch, int keys_batch, int n, int tokens,
                          int splits, cudaStream_t st) {
  if (batch < 1 || tokens < 1 || n < 1 || splits < 1 || (keys_batch != 1 && keys_batch != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kKT - 1) / kKT, len = (tiles + splits - 1) / splits;
  if ((splits - 1) * len >= tiles) return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = keys_batch == 1 && batch > 1;
  const int ntt = (min(tokens, kTokGroup) + 15) / 16, group = shared ? t2i_group(ntt) : 1;
  const int items = (batch + group - 1) / group * ((tokens + kTokGroup - 1) / kTokGroup) * splits;
  const int grid = min(device_info().sms, items);
  int err;
#define T2I_LAUNCH(NTT, G, PROJECT, SMEM, SRC, ROWS)                                          \
  t2i_launch<NTT, G, PROJECT, ROWS>(grid, SMEM, st, qb, SRC, pe, wkb, bkb, wvb, bvb, po, pml,  \
                                    batch, n, tokens, splits)
  if (shared) {
    const size_t smem = kT2iW / 2 + kT2iX;
    cudaError_t e = cudaFuncSetAttribute(t2i_project_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    t2i_project_kernel<<<dim3(tiles, 2), 128, smem, st>>>(keys, pe, wkb, bkb, wvb, bvb, kpv, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    const bf16* kv = kpv;
    switch (ntt) {
      case 1:
        err = tokens <= 8 ? T2I_LAUNCH(1, 4, false, kT2iAttSmem, kv, 1)
                          : T2I_LAUNCH(1, 4, false, kT2iAttSmem, kv, 2);
        break;
      case 2: err = T2I_LAUNCH(2, 2, false, kT2iAttSmem, kv, 2); break;
      case 3: err = T2I_LAUNCH(3, 1, false, kT2iAttSmem, kv, 2); break;
      default: err = T2I_LAUNCH(4, 1, false, kT2iAttSmem, kv, 2); break;
    }
  } else {
    switch (ntt) {
      case 1:
        err = tokens <= 8 ? T2I_LAUNCH(1, 1, true, kT2iProjSmem, keys, 1)
                          : T2I_LAUNCH(1, 1, true, kT2iProjSmem, keys, 2);
        break;
      case 2: err = T2I_LAUNCH(2, 1, true, kT2iProjSmem, keys, 2); break;
      case 3: err = T2I_LAUNCH(3, 1, true, kT2iProjSmem, keys, 2); break;
      default: err = T2I_LAUNCH(4, 1, true, kT2iProjSmem, keys, 2); break;
    }
  }
#undef T2I_LAUNCH
  if (err) return err;
  const int threads = batch * tokens * 16;
  t2i_merge_kernel<<<(threads + 255) / 256, 256, 0, st>>>(po, pml, out, batch, tokens, splits);
  return static_cast<int>(cudaGetLastError());
}

// The body of iuvl_i2t_block_step (its contract there), on stream st, with
// the k / v stride and the rounding order of i2t_block_kernel.
template <bool kResFirst>
int i2t_block_run(const bf16* keys, const bf16* pe_wq, const bf16* kp, const bf16* vp,
                  int kv_stride, const bf16* wq, const bf16* bq, const bf16* wo, const bf16* bo,
                  const float* ln_w, const float* ln_b, bf16* out, int batch, int keys_batch,
                  int n, int tokens, float scale, float eps, cudaStream_t st) {
  if (batch < 1 || tokens < 1 || n < 1 || (keys_batch != 1 && keys_batch != batch))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tiled = tokens > kKvTile;
  const DeviceInfo dev = device_info();
  const int sms = dev.sms, max_smem = dev.smem_per_block;
  // Two token stages where they fit beside 8 warps' x strips, else one;
  // fewer warps only where one stage does not fit beside 8 strips. Past 64
  // tokens one stage of a 64-token tile.
  const size_t stage = size_t{2} * (tiled ? kKvTile : (tokens + 15) / 16 * 16) * kLdI * 2;
  int stages = tiled ? 1 : 2, nw = kWarps;
  auto bytes = [&] { return kRegionA + kRegionB + kParams + stages * stage + nw * kSlot; };
  while (bytes() > static_cast<size_t>(max_smem)) {
    if (stages == 2) stages = 1;
    else if (--nw == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = ((n + kStrip - 1) / kStrip + nw - 1) / nw;
  const int grid = min(sms, batch * groups);
  auto kernel = tiled ? (n % kStrip ? i2t_block_kernel<true, kResFirst, true>
                                    : i2t_block_kernel<false, kResFirst, true>)
                      : (n % kStrip ? i2t_block_kernel<true, kResFirst, false>
                                    : i2t_block_kernel<false, kResFirst, false>);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, nw * 32, bytes(), st>>>(keys, pe_wq, kp, vp, wq, bq, wo, bo, ln_w, ln_b, out,
                                         batch, n, tokens, kv_stride,
                                         static_cast<int>(keys_batch == 1 && batch > 1), scale,
                                         eps, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace twoway
}  // namespace
}  // namespace iuvl
