// Global-block rel-pos flash attention with the output projection (B2):
//   s = q.k + relw[q, k % w] + relh[q, k / w]   (q pre-scaled)
//   out[b, n, :] = bo + sum_h softmax(s)_h @ v_h @ Wo[:, h]^T
// Replaces iuvl_tpu/ops/pallas/flash_attention.py:flash_attention_rowbias_proj.
//
// Bound on the card: operations. 4 B H N^2 d for the attention (51.5 GFLOP
// at ViT-B 1024^2, 0.052 ms at 989 TFLOP/s) and 2 B N C^2 for the
// projection (4.8 GFLOP, 0.005 ms); the N x N scores must never reach
// device memory. The TPU kernel walked a sequential (q block, head, k
// block) grid with the projection's accumulator persistent in VMEM. Here
// the call is two kernels behind the one C entry:
// - Attention: B2b's streaming forward (rowbias_fwd.cuh, shared with
//   flash_attention_rowbias.cu): a block of four warps owns a 64-query
//   tile of one (batch, head) and loops over 64-key tiles with s, p and
//   the output sums in registers (mma.sync m16n8k16), K and V by cp.async
//   into a two-stage ring; at w 64 relw sits in 32 registers a lane and
//   relh is one value a row a tile, at other w both come from the tile's
//   relh | relw rows in shared memory. Each head's bf16(acc / l) is written
//   once into a (B, H, N, d) bf16 scratch (6.3 MB at ViT-B, which stays in
//   L2), with its lse (unused) beside it: the kernel is B2b's own, so its
//   registers and timing are too (a copy that wrote token-major rows
//   without the lse spilled a register at w 64). 768 blocks at ViT-B,
//   three to an SM.
// - Projection: out = bf16(bo + o Wo^T) by the wgmma GEMM of
//   linear_wgmma.cuh, which reads the scratch as the token-major (B N, H d)
//   matrix, the fp32 accumulator initialised from bo.
// Measured (ptxas on the card; no spills): the attention 168 registers and
// 54,272 bytes of shared memory a block at w 64 (3 an SM), 139 and 46,080
// at w 32; the GEMM 128 registers, 99,328 bytes. On the card (H100 SXM,
// 700 W; tools/kernel_ab.py, PERF.md) the call takes 0.268 ms at ViT-B
// 1024^2 against its 0.057 ms bound: 0.237 ms of device time the attention
// (B2b's), 0.023 the projection.
//
// Rounding points follow the TPU kernel: s = (q.k + relw) + relh in fp32;
// the unnormalised p = exp(s - m) rounded to bf16 per 64-key tile for
// p @ v; o_h = bf16(acc / l); out = bf16(bo + sum_h o_h Wo_h), the sum in
// fp32.
#include "linear_wgmma.cuh"
#include "rowbias_fwd.cuh"

namespace iuvl {
namespace {

template <int D, int kBias>
int launch_attention(const bf16* q, const bf16* k, const bf16* v, const bf16* relh,
                     const bf16* relw, bf16* o, float* lse, int bh, int n, int h, int w, int ka,
                     cudaStream_t s) {
  const size_t smem = FwdSmem<D>::stream(ka, false);
  if (int err = set_smem(rb_fwd_stream_kernel<D, kBias>, smem)) return err;
  rb_fwd_stream_kernel<D, kBias><<<dim3((n + kT - 1) / kT, bh), kRT, smem, s>>>(
      q, k, v, relh, relw, nullptr, nullptr, nullptr, o, lse, n, h, w, ka);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int rowbias_proj(const bf16* q, const bf16* k, const bf16* v, const bf16* relh, const bf16* relw,
                 const bf16* wo, const float* bo, bf16* out, bf16* o, float* lse, int batch,
                 int heads, int n, int c_out, int w, cudaStream_t s) {
  const int h = n / w, ka = (h + w + 15) / 16 * 16, bh = batch * heads;
  if (ka / 16 > 31) return static_cast<int>(cudaErrorInvalidValue);
  const int err = w == kT ? launch_attention<D, kBiasW64>(q, k, v, relh, relw, o, lse, bh, n, h,
                                                          w, ka, s)
                          : launch_attention<D, kBiasIdx>(q, k, v, relh, relw, o, lse, bh, n, h,
                                                          w, ka, s);
  if (err) return err;
  return linear_wgmma<kEpiBiasInit, true>(o, wo, bo, out, batch * n, c_out, heads * D, n, D, s);
}

}  // namespace
}  // namespace iuvl

using namespace iuvl;

// q (pre-scaled), k, v: (B, H, N, d) bf16 with d 64 or 80; relh: (B, H, N,
// N/w) bf16; relw: (B, H, N, w) bf16; wo: (C, H*d) bf16; bo: (C) fp32;
// out: (B, N, C) bf16; scratch: o_scratch (B, H, N, d) bf16, the head
// outputs, and lse_scratch (B, H, N) fp32. w a power of two dividing N,
// C % 8 == 0.
extern "C" int iuvl_rowbias_proj(const void* q, const void* k, const void* v, const void* relh,
                                 const void* relw, const void* wo, const void* bo, void* out,
                                 void* o_scratch, void* lse_scratch, int batch, int heads, int n,
                                 int c_out, int d, int w, void* stream) {
  if (w < 1 || (w & (w - 1)) || n % w || c_out % 8 || batch < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* rh = static_cast<const bf16*>(relh);
  const auto* rw = static_cast<const bf16*>(relw);
  const auto* wob = static_cast<const bf16*>(wo);
  const auto* bof = static_cast<const float*>(bo);
  auto* ob = static_cast<bf16*>(out);
  auto* os = static_cast<bf16*>(o_scratch);
  auto* ls = static_cast<float*>(lse_scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return rowbias_proj<64>(qb, kb, vb, rh, rw, wob, bof, ob, os, ls, batch, heads, n,
                                     c_out, w, s);
    case 80: return rowbias_proj<80>(qb, kb, vb, rh, rw, wob, bof, ob, os, ls, batch, heads, n,
                                     c_out, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
