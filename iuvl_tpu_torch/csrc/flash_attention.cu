// Global-block rel-pos flash attention with the output projection folded in:
//   s = q.k + relw[q, k % w] + relh[q, k / w]   (q pre-scaled)
//   out[b, n, :] = sum_h softmax(s)_h @ v_h @ Wo[:, h]^T + bo
// Replaces iuvl_tpu/ops/pallas/flash_attention.py:flash_attention_rowbias_proj.
//
// Bound on the card: 4*B*H*N^2*d FLOPs (51.5 GFLOP for ViT-B at 1024^2)
// plus 2*B*N*C^2 (4.8 GFLOP) for the projection; tensor-core bound, and
// the N x N scores must never reach device memory. The TPU kernel walked a
// sequential (q-block, head, k-block) grid with a persistent projection
// accumulator; blocks on the card run in no order, so that grid becomes
// loops inside one block per (batch, 32-query tile): over heads, and
// inside each head over 64-key tiles with an online softmax. relh is
// constant over each w-wide key group, so with 64-key tiles (w == 64) it
// is one scalar per query row and tile. The 32 x C fp32 projection
// accumulator lives in shared memory (96 KB at C = 768); each warp keeps
// its 16 x 16 tile of the head's output accumulator in registers and
// rescales it by the tile's alpha per row.
//
// Rounding points follow the TPU kernel: s = (q.k + relh) + relw in fp32;
// the unnormalised p = exp(s - m) rounded to bf16 for p @ v; o_h =
// bf16(acc / l); out = bf16(bo + sum_h o_h Wo_h), the sum in fp32.
#include "common.cuh"

namespace iuvl {
namespace {

constexpr int kD = 64;   // head dim
constexpr int kBQ = 32;  // queries per block
constexpr int kBK = 64;  // keys per tile (== w)
// Shared-memory row strides, padded so that the rows a fragment load or
// store touches at once fall on different banks.
constexpr int kLdS = kBK + 4;  // scores, O (fp32)
constexpr int kLdP = kBK + 8;  // probabilities, O_h (bf16)
constexpr int kLdK = kD + 8;   // K and V tiles (bf16)
constexpr int kTile = 2 * kBK * kLdK;  // one slot: a K tile, then a V tile (bf16)

size_t smem_bytes(int c_out) {
  return (kBQ * (c_out + 4) + 2 * kBQ * kLdS + 3 * kBQ) * sizeof(float) +
         (2 * kBQ * kLdP + 2 * kTile + 2 * kBQ * kBK) * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads) rowbias_proj_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ relh, const bf16* __restrict__ relw,
    const bf16* __restrict__ wo, const float* __restrict__ bo, bf16* __restrict__ out,
    int heads, int n, int c_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldacc = c_out + 4;
  float* pacc = reinterpret_cast<float*>(smem);          // kBQ x ldacc
  float* S = pacc + kBQ * ldacc;                         // kBQ x kLdS
  float* O = S + kBQ * kLdS;                             // kBQ x kLdS (kD wide)
  bf16* P = reinterpret_cast<bf16*>(O + kBQ * kLdS);     // kBQ x kLdP
  bf16* Oh = P + kBQ * kLdP;                             // kBQ x kLdP (kD wide)
  float* m_s = reinterpret_cast<float*>(Oh + kBQ * kLdP);  // kBQ
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;  // the current tile's alpha per row
  bf16* kv = reinterpret_cast<bf16*>(a_s + kBQ);  // two slots of K, V tiles
  bf16* rw_s = kv + 2 * kTile;                    // kBQ x kBK: relw of this head
  bf16* rh_s = rw_s + kBQ * kBK;                  // kBQ x groups (== kBK): relh

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int c_in = heads * kD;
  const int groups = n / kBK;  // relh width (n / w)
  const int rt = warp >> 2, ct = warp & 3;  // this warp's 16x16 tile of S and O
  const int ptiles = 2 * (c_out / 16);

  for (int i = tid; i < kBQ * ldacc; i += kThreads) pacc[i] = bo[i % ldacc < c_out ? i % ldacc : 0];
  float* st = O + warp * 256;  // this warp's 16 x 16 staging tile
  const int orow = lane >> 1, ocol = (lane & 1) * 8;  // lane's 8 values of the warp's O tile

  for (int h = 0; h < heads; ++h) {
    const size_t bh = static_cast<size_t>(b) * heads + h;
    const bf16* qh = q + (bh * n + q0) * kD;
    const bf16* kh = k + bh * n * kD;
    const bf16* vh = v + bh * n * kD;
    // K and V tiles stream through two slots by cp.async, one tile ahead;
    // this head's relw (constant over key tiles) and relh rows come once.
    auto stage_tile = [&](int kt) {
      bf16* slot = kv + (kt & 1) * kTile;
      for (int i = tid; i < 2 * kBK * (kD / 8); i += kThreads) {
        const int part = i / (kBK * (kD / 8)), j = i % (kBK * (kD / 8));
        const int r = j / (kD / 8), c = (j % (kD / 8)) * 8;
        cp_async16(slot + part * kBK * kLdK + r * kLdK + c,
                   (part ? vh : kh) + (static_cast<size_t>(kt) * kBK + r) * kD + c);
      }
    };
    for (int i = tid; i < kBQ * kBK / 8; i += kThreads) {
      cp_async16(rw_s + i * 8, relw + (bh * n + q0) * kBK + i * 8);
      cp_async16(rh_s + i * 8, relh + (bh * n + q0) * groups + i * 8);
    }
    stage_tile(0);
    cp_async_commit();
    if (tid < kBQ) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    FragA qa[kD / 16];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qh + rt * 16 * kD + kk * 16, kD);

    // Scores of key tile kt for this warp's 16x16 tile, into S; then the
    // block's scores s = (q.k + relh) + relw of rows r for one lane's 2 keys.
    auto score_tile = [&](const bf16* kt_s) {
      FragC sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBc kb;  // B[k][n] = K[ct*16 + n][kk*16 + k] of the tile
        wmma::load_matrix_sync(kb, kt_s + ct * 16 * kLdK + kk * 16, kLdK);
        wmma::mma_sync(sc, qa[kk], kb, sc);
      }
      wmma::store_matrix_sync(S + rt * 16 * kLdS + ct * 16, sc, kLdS, wmma::mem_row_major);
    };
    auto scores = [&](int r, int kt, float& s0, float& s1) {
      const float rh = to_f(rh_s[r * groups + kt]);
      s0 = S[r * kLdS + lane] + rh + to_f(rw_s[r * kBK + lane]);
      s1 = S[r * kLdS + lane + 32] + rh + to_f(rw_s[r * kBK + lane + 32]);
    };

    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = 0.f;
    for (int kt = 0; kt < groups; ++kt) {
      cp_async_wait<0>();
      __syncthreads();  // tile kt has landed; P and a_s of tile kt - 1 are consumed
      const bf16* kt_s = kv + (kt & 1) * kTile;
      score_tile(kt_s);
      __syncthreads();  // S is complete; the slot of tile kt - 1 is free
      if (kt + 1 < groups) stage_tile(kt + 1);
      cp_async_commit();
      for (int rr = 0; rr < kBQ / kWarps; ++rr) {
        const int r = warp * (kBQ / kWarps) + rr;
        float s0, s1;
        scores(r, kt, s0, s1);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        P[r * kLdP + lane] = to_bf(p0);
        P[r * kLdP + lane + 32] = to_bf(p1);
        const float psum = warp_sum(p0 + p1);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + psum;
          a_s[r] = alpha;
        }
      }
      __syncthreads();
      FragC oc;
      wmma::fill_fragment(oc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA pa;
        wmma::load_matrix_sync(pa, P + rt * 16 * kLdP + kk * 16, kLdP);
        FragBr vb;  // B[k][n] = V[kk*16 + k][ct*16 + n] of the tile
        wmma::load_matrix_sync(vb, kt_s + kBK * kLdK + kk * 16 * kLdK + ct * 16, kLdK);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(st, oc, 16, wmma::mem_row_major);
      __syncwarp();
      const float alpha = a_s[rt * 16 + orow];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = o[j] * alpha + st[orow * 16 + ocol + j];
      __syncwarp();
    }
    {
      const int r = rt * 16 + orow;
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j) Oh[r * kLdP + ct * 16 + ocol + j] = to_bf(o[j] / l);
    }
    __syncthreads();

    for (int t = warp; t < ptiles; t += kWarps) {
      const int prt = t & 1, pct = t >> 1;
      FragC pc;
      float* pt = pacc + prt * 16 * ldacc + pct * 16;
      wmma::load_matrix_sync(pc, pt, ldacc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragA oa;
        wmma::load_matrix_sync(oa, Oh + prt * 16 * kLdP + kk * 16, kLdP);
        FragBc wb;  // B[k][n] = Wo[pct*16 + n][h*64 + kk*16 + k]
        wmma::load_matrix_sync(wb, wo + static_cast<size_t>(pct * 16) * c_in + h * kD + kk * 16,
                               c_in);
        wmma::mma_sync(pc, oa, wb, pc);
      }
      wmma::store_matrix_sync(pt, pc, ldacc, wmma::mem_row_major);
    }
    __syncthreads();
  }

  bf16* ob = out + (static_cast<size_t>(b) * n + q0) * c_out;
  for (int i = tid; i < kBQ * c_out; i += kThreads)
    ob[i] = to_bf(pacc[(i / c_out) * ldacc + i % c_out]);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q (pre-scaled), k, v: (B, H, N, 64) bf16; relh: (B, H, N, N/64) bf16;
// relw: (B, H, N, 64) bf16; wo: (C, H*64) bf16; bo: (C) fp32; out: (B, N, C)
// bf16. w == 64, N % 64 == 0, C % 16 == 0.
extern "C" int iuvl_rowbias_proj(const void* q, const void* k, const void* v, const void* relh,
                                 const void* relw, const void* wo, const void* bo, void* out,
                                 int batch, int heads, int n, int c_out, int w, void* stream) {
  if (w != kBK || n != kBK * kBK || c_out % 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(rowbias_proj_kernel, dim3(n / kBQ, batch), smem_bytes(c_out), stream,
                       static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<const bf16*>(relh),
                       static_cast<const bf16*>(relw), static_cast<const bf16*>(wo),
                       static_cast<const float*>(bo), static_cast<bf16*>(out), heads, n, c_out);
}
