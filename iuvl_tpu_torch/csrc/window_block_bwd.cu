// Backward of the whole windowed-attention module body (B9): from the
// windows' input xw and the output cotangent g, recompute the forward and
// return dx, dWqkv, dbqkv, dWo, dbo and the gradients of the expanded
// rel-pos tables Rh, Rw. Replaces
// iuvl_tpu/ops/pallas/window_block.py:_block_backward; the Rh -> rel_pos_h
// expansion VJP stays outside, in PyTorch, as _wab_bwd keeps it in XLA.
//
// Bound on the card: operations, ~2.9 GFLOP a 14 x 14 window at ViT-B
// (the qkv and projection products of the forward recompute, dx, dWqkv,
// dWo, and about 3x the attention's forward work) against ~1 MB of
// inputs. The TPU kernel walked the windows in a serial grid and kept
// dWqkv, dWo and the table gradients as VMEM accumulators across it. On
// the card the windows run in parallel, so the work is split by what
// depends on what, each piece a pass of its own over all windows:
//   1. qkv = x @ Wqkv^T + b and do = g @ Wo: tiled GEMMs (gemm.cuh).
//   2. one block per (window, head) recomputes the scores and
//      probabilities a 16-query tile at a time in shared memory, emits the
//      recomputed head output o_h (for dWo), dq (with the rel-pos terms)
//      and the tile's bf16 p and ds rows (to an L2-resident scratch), then
//      dk = ds^T q and dv = p^T do over the whole window, and its partial
//      of dRh and dRw.
//   3. dx = dqkv @ Wqkv, and the weight gradients dWqkv = dqkv^T x and
//      dWo = g^T o as GEMMs whose depth is every token row of every
//      window: one block owns an output tile and sums all rows, so no
//      partial sums and no atomics. Bias gradients are column sums; the
//      table gradients sum the per-(window, head) partials in a fixed
//      order. Every result is the same on every run.
//
// The head dim is a template parameter, 64 (ViT-B/L) or 80 (ViT-H); the
// scores are bf16(q d^-1/2) . k as in the forward (at 64, where 1/8 is
// exact either way, the fp32 scores are scaled instead). At 80
// the per-(window, head) tiles take 146 KB of shared memory, so relh, relw
// and their cotangents (bf16-rounded values, held exactly in bf16) are kept
// in bf16 there and in fp32 at 64.
//
// Rounding points follow the plain version, window_block_backward_plain
// (the arithmetic of the TPU kernel on the forward's rounding): qkv =
// bf16(bf16(x W^T) + bf16(b)); relh, relw = bf16(q . R); scores and
// softmax fp32; o_h = bf16(bf16(p) v); do = bf16(g Wo); ds =
// p (dp - rowsum(dp p)) in fp32, rounded to bf16 for dq and dk; the
// rel-pos cotangents drelh, drelw rounded to bf16; dq, dk, dv, dx bf16;
// weight, bias and table gradients fp32.
#include "gemm.cuh"

namespace iuvl {
namespace {

constexpr int kWin = 14;
constexpr int kN = kWin * kWin;      // 196 tokens a window
constexpr int kRT = (kN + 15) / 16;  // 13 row tiles
constexpr int kNP = kRT * 16;        // 208
constexpr int kLdS = kNP + 4;        // score rows (fp32)
constexpr int kLdP = kNP + 8;        // p, ds rows (bf16)

// kHd: the head dim; Rel: the storage type of relh, relw, drelh, drelw.
template <int kHd>
struct WinBwd {
  using Rel = std::conditional_t<(kHd > 64), bf16, float>;
  static constexpr int kLdT = kHd + 8;  // q, k, v, do rows (bf16)
  static constexpr int kTab = kWin * kWin * kHd;  // one expanded table
  static constexpr size_t kSmemTiles = 4 * kNP * kLdT * sizeof(bf16);
  static constexpr size_t kSmemRel = 4 * kNP * kWin * sizeof(Rel);
  static constexpr size_t kSmemRow = 2 * 16 * kLdS * sizeof(float) + 2 * 16 * kLdP * sizeof(bf16);
  static constexpr size_t kSmemStage = kWarps * 256 * sizeof(float);
  static constexpr size_t kSmemAttn = kSmemTiles + kSmemRel + kSmemRow + kSmemStage;
};

__device__ __forceinline__ void set_rel(float& d, float v) { d = v; }
__device__ __forceinline__ void set_rel(bf16& d, float v) { d = to_bf(v); }

template <int kHd>
__global__ void __launch_bounds__(kThreads) window_attn_bwd_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dob, const float* __restrict__ rh,
    const float* __restrict__ rw, bf16* __restrict__ obuf, bf16* __restrict__ dqkv,
    bf16* __restrict__ pbuf, bf16* __restrict__ dsbuf, float* __restrict__ drel_part, int C) {
  using W = WinBwd<kHd>;
  using Rel = typename W::Rel;
  constexpr int kLdT = W::kLdT, kTab = W::kTab;
  const float kScale = 1.f / sqrtf(static_cast<float>(kHd));  // 64: exact 0.125
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kNP * kLdT;
  bf16* Vs = Ks + kNP * kLdT;
  bf16* dOs = Vs + kNP * kLdT;
  Rel* relh = reinterpret_cast<Rel*>(dOs + kNP * kLdT);  // [kNP][kWin]
  Rel* relw = relh + kNP * kWin;
  Rel* drelh = relw + kNP * kWin;
  Rel* drelw = drelh + kNP * kWin;
  float* S = reinterpret_cast<float*>(drelw + kNP * kWin);  // [16][kLdS]: scores, then ds
  float* dP = S + 16 * kLdS;
  bf16* Pt = reinterpret_cast<bf16*>(dP + 16 * kLdS);  // [16][kLdP]
  bf16* DSt = Pt + 16 * kLdP;
  float* stage = reinterpret_cast<float*>(DSt + 16 * kLdP) + (threadIdx.x >> 5) * 256;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int heads = C / kHd, C3 = 3 * C;
  const int wh = blockIdx.x, win = wh / heads, h = wh % heads;
  const size_t row0 = static_cast<size_t>(win) * kN;  // first token row of the window
  bf16* pg = pbuf + static_cast<size_t>(wh) * kNP * kNP;
  bf16* dsg = dsbuf + static_cast<size_t>(wh) * kNP * kNP;

  // ---- load q, k, v of head h and its do; pad rows are zero ----
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kNP * (kHd / 8); i += kThreads) {
    const int r = i / (kHd / 8), v = (i % (kHd / 8)) * 8;
    const bool in = r < kN;
    const bf16* src = qkv + (row0 + r) * C3 + h * kHd + v;
    *reinterpret_cast<uint4*>(Qs + r * kLdT + v) = in ? *reinterpret_cast<const uint4*>(src) : zero;
    *reinterpret_cast<uint4*>(Ks + r * kLdT + v) =
        in ? *reinterpret_cast<const uint4*>(src + C) : zero;
    *reinterpret_cast<uint4*>(Vs + r * kLdT + v) =
        in ? *reinterpret_cast<const uint4*>(src + 2 * C) : zero;
    *reinterpret_cast<uint4*>(dOs + r * kLdT + v) =
        in ? *reinterpret_cast<const uint4*>(dob + (row0 + r) * C + h * kHd + v) : zero;
  }
  for (int i = tid; i < 4 * kNP * kWin; i += kThreads) set_rel(relh[i], 0.f);  // relh .. drelw
  __syncthreads();
  // relh/relw = bf16(q_i . R): a warp a query row, lanes over the head dim.
  constexpr int kQL = (kHd + 31) / 32;  // head-dim entries a lane
  for (int i = warp; i < kN; i += kWarps) {
    float qv[kQL];
#pragma unroll
    for (int u = 0; u < kQL; ++u)
      qv[u] = lane + 32 * u < kHd ? to_f(Qs[i * kLdT + lane + 32 * u]) : 0.f;
    for (int j = 0; j < 2 * kWin; ++j) {
      const float* R = j < kWin ? rh + ((i / kWin) * kWin + j) * kHd
                                : rw + ((i % kWin) * kWin + (j - kWin)) * kHd;
      // Both 32-wide halves in one expression (its FMA contraction sets the
      // rounding); a third, partial term at head dim 80.
      float part = qv[0] * R[lane] + qv[1] * R[lane + 32];
#pragma unroll
      for (int u = 2; u < kQL; ++u)
        if (lane + 32 * u < kHd) part += qv[u] * R[lane + 32 * u];
      const float s = round_bf(warp_sum(part));
      if (lane == 0) set_rel(j < kWin ? relh[i * kWin + j] : relw[i * kWin + j - kWin], s);
    }
  }
  __syncthreads();

  for (int qt = 0; qt < kRT; ++qt) {
    // ---- scores and dp = do v^T of the tile's 16 queries ----
    for (int ct = warp; ct < kRT; ct += kWarps) {
      FragC sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd; kk += 16) {
        FragA fa;
        FragBc fb;  // B[d][key] = K[key][d]
        wmma::load_matrix_sync(fa, Qs + qt * 16 * kLdT + kk, kLdT);
        if (kHd != 64) {  // bf16(q * scale); at 64 the fp32 scores are scaled below
#pragma unroll
          for (int e = 0; e < fa.num_elements; ++e) fa.x[e] = to_bf(to_f(fa.x[e]) * kScale);
        }
        wmma::load_matrix_sync(fb, Ks + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(sc, fa, fb, sc);
        wmma::load_matrix_sync(fa, dOs + qt * 16 * kLdT + kk, kLdT);
        wmma::load_matrix_sync(fb, Vs + ct * 16 * kLdT + kk, kLdT);
        wmma::mma_sync(dc, fa, fb, dc);
      }
      wmma::store_matrix_sync(S + ct * 16, sc, kLdS, wmma::mem_row_major);
      wmma::store_matrix_sync(dP + ct * 16, dc, kLdS, wmma::mem_row_major);
    }
    __syncthreads();
    // ---- softmax, ds, the rel-pos cotangents: a warp two rows ----
    for (int r = warp * 2; r < warp * 2 + 2; ++r) {
      const int i = qt * 16 + r;
      float* Srow = S + r * kLdS;
      const float* Drow = dP + r * kLdS;
      bf16* Prow = Pt + r * kLdP;
      bf16* DSrow = DSt + r * kLdP;
      if (i >= kN) {
        for (int c = lane; c < kNP; c += 32) {
          Prow[c] = DSrow[c] = pg[i * kNP + c] = dsg[i * kNP + c] = to_bf(0.f);
        }
        continue;
      }
      constexpr int kCols = (kNP + 31) / 32;  // 7
      float p[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int c = lane + 32 * m;
        p[m] = kNegInf;
        if (c < kN) {
          p[m] = Srow[c] * (kHd == 64 ? kScale : 1.f) + as_f(relh[i * kWin + c / kWin]) +
                 as_f(relw[i * kWin + c % kWin]);
          mx = fmaxf(mx, p[m]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int c = lane + 32 * m;
        p[m] = c < kN ? expf(p[m] - mx) : 0.f;
        sum += p[m];
      }
      sum = warp_sum(sum);
      float dpp = 0.f;
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int c = lane + 32 * m;
        p[m] = p[m] / sum;
        if (c < kNP) dpp += p[m] * Drow[c];
      }
      dpp = warp_sum(dpp);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        const int c = lane + 32 * m;
        if (c < kNP) {
          const float ds = p[m] * (Drow[c] - dpp);
          const bf16 pb = to_bf(p[m]), db = to_bf(ds);
          Prow[c] = pb;
          DSrow[c] = db;
          pg[i * kNP + c] = pb;
          dsg[i * kNP + c] = db;
          Srow[c] = ds;
        }
      }
      __syncwarp();
      if (lane < kWin) {  // drelh[i][a] = sum of ds over key row a
        float t = 0.f;
        for (int c = 0; c < kWin; ++c) t += Srow[lane * kWin + c];
        set_rel(drelh[i * kWin + lane], round_bf(t));
      } else if (lane < 2 * kWin) {  // drelw[i][b] = sum of ds over key column b
        const int b = lane - kWin;
        float t = 0.f;
        for (int a = 0; a < kWin; ++a) t += Srow[a * kWin + b];
        set_rel(drelw[i * kWin + b], round_bf(t));
      }
    }
    __syncthreads();
    // ---- o_h = p v (warps 0-3) and dq = scale ds k + rel-pos terms (4-7),
    // a 16-wide column tile u of the head dim at a time ----
    for (int u = warp & 3; u < kHd / 16; u += 4) {
      const bool is_q = warp >= 4;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kt = 0; kt < kRT; ++kt) {
        FragA fa;
        FragBr fb;  // B[key][d]
        wmma::load_matrix_sync(fa, (is_q ? DSt : Pt) + kt * 16, kLdP);
        wmma::load_matrix_sync(fb, (is_q ? Ks : Vs) + kt * 16 * kLdT + u * 16, kLdT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = qt * 16 + e / 16, d = u * 16 + e % 16;
        if (i >= kN) continue;
        if (!is_q) {
          obuf[(row0 + i) * C + h * kHd + d] = to_bf(stage[e]);
          continue;
        }
        float t = stage[e] * kScale;
        const float* Rh = rh + (i / kWin) * kWin * kHd + d;
        const float* Rw = rw + (i % kWin) * kWin * kHd + d;
        for (int a = 0; a < kWin; ++a)
          t += as_f(drelh[i * kWin + a]) * Rh[a * kHd] + as_f(drelw[i * kWin + a]) * Rw[a * kHd];
        dqkv[(row0 + i) * C3 + h * kHd + d] = to_bf(t);
      }
    }
    __syncthreads();  // S, dP, Pt, DSt are reused by the next tile
  }

  // ---- dv = p^T do and dk = scale ds^T q over the whole window ----
  using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  constexpr int kUT = kHd / 16;  // column tiles of the head dim
  for (int t = warp; t < 2 * kRT * kUT; t += kWarps) {
    const bool is_k = t >= kRT * kUT;
    const int jt = (t % (kRT * kUT)) / kUT, u = t % kUT;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kt = 0; kt < kRT; ++kt) {
      FragACol fa;  // A[key][query] = P[query][key]
      FragBr fb;    // B[query][d]
      wmma::load_matrix_sync(fa, (is_k ? dsg : pg) + kt * 16 * kNP + jt * 16, kNP);
      wmma::load_matrix_sync(fb, (is_k ? Qs : dOs) + kt * 16 * kLdT + u * 16, kLdT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int j = jt * 16 + e / 16, d = u * 16 + e % 16;
      if (j < kN)
        dqkv[(row0 + j) * C3 + (is_k ? C : 2 * C) + h * kHd + d] =
            to_bf(is_k ? stage[e] * kScale : stage[e]);
    }
    __syncwarp();
  }

  // ---- this (window, head)'s share of dRh and dRw ----
  // dRh[qh][a][d] = sum_c drelh[qh*14 + c][a] q[qh*14 + c][d];
  // dRw[qw][b][d] = sum_r drelw[r*14 + qw][b] q[r*14 + qw][d].
  float* part = drel_part + static_cast<size_t>(wh) * 2 * kTab;
  for (int o = tid; o < 2 * kTab; o += kThreads) {
    const bool is_w = o >= kTab;
    const int x = (o % kTab) / (kWin * kHd), a = (o / kHd) % kWin, d = o % kHd;
    float t = 0.f;
    for (int c = 0; c < kWin; ++c) {
      const int i = is_w ? c * kWin + x : x * kWin + c;
      t += as_f((is_w ? drelw : drelh)[i * kWin + a]) * to_f(Qs[i * kLdT + d]);
    }
    part[o] = t;
  }
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// xw, g, dx: (nW * 196, C) bf16 token rows of the windows; wqkv (3C, C) and
// wo (C, C) bf16 in nn.Linear layout; bqkv (3C) fp32; rh, rw (14, 14, d)
// fp32 with d (head_dim) 64 or 80. Scratch (wrapper-allocated): f32buf
// (nW*196, 3C) fp32; qkv, dqkv (nW*196, 3C) bf16; obuf, dobuf (nW*196, C)
// bf16; pbuf, dsbuf (nW*heads, 208, 208) bf16; drel_part (nW*heads, 2, 14,
// 14, d) fp32. Outputs: dx; dwqkv (3C, C), dbqkv (3C), dwo (C, C), dbo (C)
// and drhw (2, 14, 14, d) = (dRh, dRw), all fp32.
extern "C" int iuvl_window_block_bwd(const void* xw, const void* g, const void* wqkv,
                                     const void* bqkv, const void* wo, const void* rh,
                                     const void* rw, void* f32buf, void* qkv, void* dqkv,
                                     void* obuf, void* dobuf, void* pbuf, void* dsbuf,
                                     void* drel_part, void* dx, void* dwqkv, void* dbqkv,
                                     void* dwo, void* dbo, void* drhw, int n_windows, int C,
                                     int win, int head_dim, void* stream) {
  if (win != kWin || C % 128 || C % head_dim || (head_dim != 64 && head_dim != 80))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = n_windows * kN, C3 = 3 * C, heads = C / head_dim;
  const bf16* x_ = static_cast<const bf16*>(xw);
  const bf16* g_ = static_cast<const bf16*>(g);
  const bf16* wqkv_ = static_cast<const bf16*>(wqkv);
  float* f32 = static_cast<float*>(f32buf);
  bf16* qkv_ = static_cast<bf16*>(qkv);
  bf16* dqkv_ = static_cast<bf16*>(dqkv);
  bf16* obuf_ = static_cast<bf16*>(obuf);
  bf16* dob_ = static_cast<bf16*>(dobuf);
  // 1. forward recompute of qkv; do = g @ Wo
  IUVL_TRY((gemm_f32<false, false>(x_, wqkv_, f32, T, C3, C, s)));
  IUVL_TRY(round_bias(f32, static_cast<const float*>(bqkv), qkv_, T, C3, s));
  IUVL_TRY((gemm_f32<false, true>(g_, static_cast<const bf16*>(wo), f32, T, C, C, s)));
  IUVL_TRY(round_bias(f32, nullptr, dob_, T, C, s));
  // 2. attention backward per (window, head)
  const auto kernel = head_dim == 64 ? window_attn_bwd_kernel<64> : window_attn_bwd_kernel<80>;
  const size_t smem = head_dim == 64 ? WinBwd<64>::kSmemAttn : WinBwd<80>::kSmemAttn;
  IUVL_TRY(static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem))));
  kernel<<<n_windows * heads, kThreads, smem, s>>>(
      qkv_, dob_, static_cast<const float*>(rh), static_cast<const float*>(rw), obuf_, dqkv_,
      static_cast<bf16*>(pbuf), static_cast<bf16*>(dsbuf), static_cast<float*>(drel_part), C);
  IUVL_TRY(static_cast<int>(cudaGetLastError()));
  // 3. dx, weight, bias and table gradients
  IUVL_TRY((gemm_f32<false, true>(dqkv_, wqkv_, f32, T, C, C3, s)));
  IUVL_TRY(round_bias(f32, nullptr, static_cast<bf16*>(dx), T, C, s));
  IUVL_TRY((gemm_f32<true, true>(dqkv_, x_, static_cast<float*>(dwqkv), C3, C, T, s)));
  IUVL_TRY((gemm_f32<true, true>(g_, obuf_, static_cast<float*>(dwo), C, C, T, s)));
  IUVL_TRY(colsum(dqkv_, static_cast<float*>(dbqkv), T, C3, s));
  IUVL_TRY(colsum(g_, static_cast<float*>(dbo), T, C, s));
  return sum_parts(static_cast<const float*>(drel_part), static_cast<float*>(drhw),
                   n_windows * heads, 2 * kWin * kWin * head_dim, s);
}
