// Whole windowed-attention module body for SAM's windowed ViT blocks (B1):
//   qkv = x @ Wqkv^T + bqkv;  per head h: o_h = softmax(q_h k_h^T * d^-1/2
//   + relh + relw) @ v_h (fp32 softmax);  out = concat_h(o_h) @ Wo^T + bo.
// Replaces iuvl_tpu/ops/pallas/window_block.py:window_attention_block.
//
// Bound on the card: operations. Per 14 x 14 window ~1.05 GFLOP of products
// (qkv 0.69, attention 0.12, projection 0.23, the rel-pos features 0.01)
// against 0.3 MB of input: 26.3 GFLOP at ViT-B 1024^2 (25 windows), 0.027 ms
// at 989 TFLOP/s. Three kernels behind the one C entry, with no cluster and
// no block that owns a window's three phases:
// - qkv: the wgmma GEMM of linear_wgmma.cuh over all windows' rows at once
//   (M = windows x 196, N = 3 C, K = C), its epilogue rounding bf16(bf16(x
//   Wqkv^T) + bf16(bqkv)) and scattering into a (windows, 3, heads, 196, d)
//   bf16 scratch, so that each (window, head)'s q, k and v are contiguous.
//   Wqkv tiles reach the tensor cores from shared memory, once a block a
//   64-deep step, not as fragments from L2 at every 16-deep step (88 MB of
//   L2 traffic at ViT-B).
// - attention, wb_attention_kernel: a block of four warps owns a (window,
//   head) pair (300 blocks at ViT-B, two to an SM), as B13's resident
//   kernel (window_attention.cu) does. Its K and V land once by cp.async,
//   K with key 14 g + c at slot 16 g + c (224 slots; the two slots past each
//   grid row are zero and masked), so that a 16-key group of a score tile
//   is one grid row g: relh[q, g] is one value a row a group and relw[q, c]
//   a fixed pair of registers a lane row (-inf at c 14, 15: the mask). relh and
//   relw come first, on the tensor cores (window_rel.cuh, which B9's
//   backward shares to recompute them): for each grid row (column) g the
//   product of its 14 query rows and the table slice Rh[g] (Rw[g]), the fp32
//   table split into three bf16 parts (three products, fp32 sums: the fp32
//   einsum of the plain version to a few ulp), rounded to bf16 into shared
//   rows. Then each warp walks 16-row strips (13 a pair) with no further
//   block barrier: three passes over the keys with the scores in registers
//   (mma.sync m16n8k16), because the plain version rounds the normalised
//   p = bf16(e / sum): as the TPU kernel, pass 1 takes each row's max,
//   pass 2 its sum of expf(s - max), pass 3 forms p = bf16(e / sum) and
//   writes it in key order into the warp's rows of shared memory, then p v
//   runs over 13 chunks of 16 keys in key order, V in key order, as the
//   plain version's product sums it. (A design with one online pass for
//   the max and sum, by ex2.approx and 1 / sum, failed chip_smoke.py's
//   pooled CE train gate at 1.52x plain bf16's distance from fp32, and one
//   that fed p from registers over the key slots, 14 keys a chunk, failed
//   its batch-2 gradient gate at 1.43x and 1.46x; with p v in key order both
//   passed: PERF.md, PR 13.) bf16(o_h) goes once into a token-major
//   (windows, 196, C) scratch.
// - projection: the same GEMM on that scratch, its epilogue bf16(bf16(o
//   Wo^T) + bf16(bo)).
// Measured (ptxas on the card; no spills): wb_attention_kernel<64> 210
// registers and 100,832 bytes of shared memory a block, <80> 214 and
// 114,656 (two blocks an SM: 264 at a time, so ViT-B's 300 pairs take two
// rounds); the GEMM 124 registers, 99,328 bytes. On the card (H100 SXM,
// 700 W; tools/kernel_ab.py, PERF.md) the call takes 0.227 ms at ViT-B
// 1024^2 against its 0.027 ms bound: the qkv GEMM 0.056 ms of device time
// (310 TFLOP/s), the attention 0.142, the projection 0.020. (The first
// build of this design, one online pass with ex2.approx and p from
// registers, three blocks an SM, took 0.048 ms for the attention.)
//
// The head dim is a template parameter of the attention: 64 (ViT-B/L) or
// 80 (ViT-H, C 1280, 16 heads). The scores are bf16(q d^-1/2) . k, as the
// plain version scales q in the working dtype (exact at 64, where d^-1/2 =
// 1/8).
//
// Rounding points follow the plain version (the JAX _block_xla math), so
// that the two differ only in summation order: qkv = bf16(bf16(x @ W) +
// bf16(b)); relh/relw = bf16(q . R) with an fp32 sum; scores fp32, s =
// (q.k + relh) + relw; p = bf16(e / sum); o_h = bf16(p @ v); out =
// bf16(bf16(o @ Wo) + bf16(bo)).
#include "linear_wgmma.cuh"
#include "window_rel.cuh"

namespace iuvl {
namespace {

constexpr int kWin = 14;            // window side
constexpr int kN = kWin * kWin;     // tokens a window
constexpr int kNP = 208;            // tokens padded to 16
constexpr int kSlots = kWin * 16;   // key slots: a grid row of 14 keys in 16
constexpr int kWbThreads = 128;     // 4 warps, each a 16-row strip at a time
constexpr int kRelLd = 2 * kWin;    // a token's bf16 relh | relw
constexpr int kLdP = kNP + 8;       // a warp's p rows (bf16), padded against bank conflicts

template <int D>
struct WbSmem {
  static constexpr int kLd = D + 8;  // K, V rows (bf16), padded against bank conflicts
  // K in key slots, V in key order, every token's relh | relw, each warp's p.
  static constexpr size_t kBytes =
      ((kSlots + kNP) * kLd + kN * kRelLd + 4 * 16 * kLdP) * sizeof(bf16);
};

// s = (q.k + relh[row, g]) + relw[row, c] for the strip's 16-key groups p <
// groups of the 64-slot tile kt (group p is grid row g = 4 kt + p, its
// slots c = 0..15), -inf in the groups past. rw[u][j]: relw of the lane's
// row u at c = 8 j + 2 (lane % 4) and c + 1, two bf16 (-inf at c >= 14: the
// masked slots); rel0, rel1 the lane's two rows of relh | relw in shared
// memory (a row past the window reads the last one: its outputs are
// dropped).
template <int D>
__device__ __forceinline__ void wb_scores(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                          const bf16* Kt, int groups, int kt,
                                          const bf16* rel0, const bf16* rel1,
                                          const uint32_t (&rw)[2][2]) {
  const bool pad = (threadIdx.x & 3) == 3;  // the lane's columns 14, 15 at j = 1
  strip_scores<D>(s, qf, Kt, D + 8, groups);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p >= groups) {
#pragma unroll
      for (int j = 2 * p; j < 2 * p + 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = kNegInf;
      continue;
    }
    const int g = 4 * kt + p;
    const float rh[2] = {to_f(rel0[g]), to_f(rel1[g])};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rw[u][j]));
        if (j == 1 && pad) w = make_float2(kNegInf, kNegInf);
        s[2 * p + j][2 * u] = (s[2 * p + j][2 * u] + rh[u]) + w.x;
        s[2 * p + j][2 * u + 1] = (s[2 * p + j][2 * u + 1] + rh[u]) + w.y;
      }
  }
}

// One (window, head) pair a block: rel-pos features, then the attention of
// its 13 strips in three passes (see the header). Two blocks an SM.
template <int D>
__global__ void __launch_bounds__(kWbThreads, 2) wb_attention_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ rh, const float* __restrict__ rw,
    bf16* __restrict__ o, int heads, float scale) {
  constexpr int kLd = WbSmem<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // kSlots x kLd: key 14 g + c at slot 16 g + c
  bf16* Vs = Ks + kSlots * kLd;              // kNP x kLd, in key order
  bf16* REL = Vs + kNP * kLd;                // kN x kRelLd
  bf16* Pw = REL + kN * kRelLd + (threadIdx.x >> 5) * 16 * kLdP;  // the warp's 16 x kLdP
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, lo = lane >> 2;
  const int q2 = 2 * (lane & 3);
  const int win = blockIdx.x / heads, hd = blockIdx.x - win * heads;
  const size_t plane = static_cast<size_t>(kN) * D;  // one (window, which, head) tile
  const bf16* qh = qkv + (static_cast<size_t>(win) * 3 * heads + hd) * plane;
  const bf16* kh = qh + heads * plane;
  const bf16* vh = kh + heads * plane;
  for (int i = tid; i < kSlots * (D / 8); i += kWbThreads) {
    const int slot = i / (D / 8), c8 = (i - slot * (D / 8)) * 8, c = slot & 15;
    const bool in = c < kWin;
    const size_t src = static_cast<size_t>(in ? (slot >> 4) * kWin + c : 0) * D + c8;
    cp_async16_zfill(Ks + slot * kLd + c8, kh + src, in);
  }
  cp_rows<D>(Vs, kLd, vh, 0, kNP, kN, tid, kWbThreads);
  cp_async_commit();
  // p's columns past the window stay zero: p v runs over 13 chunks of 16 keys.
  for (int i = lane; i < 16 * (kNP - kN); i += 32)
    Pw[(i / (kNP - kN)) * kLdP + kN + i % (kNP - kN)] = to_bf(0.f);

  rel_features<D>(qh, D, rh, rw, warp, kWbThreads / 32, [&](int tok, int t, int a, float v) {
    REL[tok * kRelLd + t * kWin + a] = to_bf(v);
  });
  cp_async_wait<0>();
  __syncthreads();  // K, V and every token's relh | relw are in shared memory

  const int C = heads * D;
  bf16* oh = o + static_cast<size_t>(win) * kN * C + hd * D;
  for (int row0 = warp * 16; row0 < kN; row0 += kWbThreads / 2) {
    const int row_lo = row0 + lo, row_hi = row_lo + 8;
    const bf16* rel0 = REL + min(row_lo, kN - 1) * kRelLd;
    const bf16* rel1 = REL + min(row_hi, kN - 1) * kRelLd;
    uint32_t rwr[2][2];  // relw of the lane's rows at its columns c, c + 1 (c <= 12 read)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = min(8 * j + q2, kWin - 2);
      rwr[0][j] = *reinterpret_cast<const uint32_t*>(rel0 + kWin + c);
      rwr[1][j] = *reinterpret_cast<const uint32_t*>(rel1 + kWin + c);
    }
    uint32_t qf[D / 16][4];  // bf16(q * scale), straight from device memory
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? row_hi : row_lo, c = kk * 16 + q2 + (e >> 1) * 8;
        uint32_t raw = 0u;
        if (row < kN) raw = *reinterpret_cast<const uint32_t*>(qh + static_cast<size_t>(row) * D + c);
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
        qf[kk][e] = pack_bf16(x.x * scale, x.y * scale);
      }
    // The TPU kernel's softmax: m = max(s), e = exp(s - m), p = bf16(e /
    // sum(e)), in three passes over the keys (max, sum, p v), the scores
    // computed anew in each.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {  // pass 1: the row max (grid rows 4 kt .., 14 in all)
      float s[8][4];
      wb_scores<D>(s, qf, Ks + kt * 64 * kLd, kt < 3 ? 4 : 2, kt, rel0, rel1, rwr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], 1));
      m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], 2));
    }
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {  // pass 2: the row sum of exp(s - m)
      float s[8][4];
      wb_scores<D>(s, qf, Ks + kt * 64 * kLd, kt < 3 ? 4 : 2, kt, rel0, rel1, rwr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[j][e] - m[e >> 1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    }
    __syncwarp();  // the previous strip's p is read
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {  // pass 3: p = bf16(e / sum) into the warp's rows, key order
      const int groups = kt < 3 ? 4 : 2;
      float s[8][4];
      wb_scores<D>(s, qf, Ks + kt * 64 * kLd, groups, kt, rel0, rel1, rwr);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= groups) break;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * j + q2;  // keys 14 g + c, c + 1 (c < 14: c is even)
          if (c >= kWin) continue;
          const int key = (4 * kt + p) * kWin + c;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            *reinterpret_cast<uint32_t*>(Pw + (lo + 8 * u) * kLdP + key) =
                pack_bf16(expf(s[2 * p + j][2 * u] - m[u]) / l[u],
                          expf(s[2 * p + j][2 * u + 1] - m[u]) / l[u]);
        }
      }
    }
    __syncwarp();
    // o = p v over 16-key chunks in key order, as the plain version's
    // product sums them.
    float oacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kNP / 16; ++kc) {
      uint32_t a[4];
      lda_rows(a, Pw, kLdP, 0, kc * 16);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldb_cols(b, Vs, kLd, dn * 16, kc * 16);  // B[key][c] = V[key][c]
        mma16816(oacc[2 * dn], a, b[0], b[1]);
        mma16816(oacc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    store_strip_rows<D>(oh, oacc, row0, kN, C);
  }
}

template <int D>
int window_block(const bf16* xw, const bf16* wqkv, const float* bqkv, const bf16* wo,
                 const float* bo, const float* rh, const float* rw, bf16* qkv, bf16* o,
                 bf16* out, int n_windows, int C, cudaStream_t s) {
  const int M = n_windows * kN, heads = C / D;
  if (int err = linear_wgmma<kEpiQkv>(xw, wqkv, bqkv, qkv, M, 3 * C, C, C, D, s)) return err;
  constexpr size_t smem = WbSmem<D>::kBytes;
  if (cudaError_t err = cudaFuncSetAttribute(
          wb_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem)))
    return static_cast<int>(err);
  wb_attention_kernel<D><<<n_windows * heads, kWbThreads, smem, s>>>(
      qkv, rh, rw, o, heads, 1.f / sqrtf(static_cast<float>(D)));
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  return linear_wgmma<kEpiRound2>(o, wo, bo, out, M, C, C, 0, 0, s);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// xw, out: (nW, 196, C) bf16; wqkv: (3C, C) bf16; bqkv: (3C) fp32; wo: (C, C)
// bf16; bo: (C) fp32; rh, rw: (14, 14, d) fp32 rel-pos tables; qkv_scratch:
// (nW, 3, heads, 196, d) bf16; o_scratch: (nW, 196, C) bf16. win == 14,
// head_dim (d) 64 or 80, C % 128 == 0.
extern "C" int iuvl_window_block(const void* xw, const void* wqkv, const void* bqkv,
                                 const void* wo, const void* bo, const void* rh, const void* rw,
                                 void* qkv_scratch, void* o_scratch, void* out, int n_windows,
                                 int C, int win, int head_dim, void* stream) {
  if (win != kWin || C % 128 || C % head_dim || n_windows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const bf16*>(xw);
  const auto* w1 = static_cast<const bf16*>(wqkv);
  const auto* b1 = static_cast<const float*>(bqkv);
  const auto* w2 = static_cast<const bf16*>(wo);
  const auto* b2 = static_cast<const float*>(bo);
  const auto* th = static_cast<const float*>(rh);
  const auto* tw = static_cast<const float*>(rw);
  auto* qkv = static_cast<bf16*>(qkv_scratch);
  auto* o = static_cast<bf16*>(o_scratch);
  auto* y = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return window_block<64>(x, w1, b1, w2, b2, th, tw, qkv, o, y, n_windows, C, s);
    case 80: return window_block<80>(x, w1, b1, w2, b2, th, tw, qkv, o, y, n_windows, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
