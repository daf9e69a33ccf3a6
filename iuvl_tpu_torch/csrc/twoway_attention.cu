// The C entries of B4 (t2i_stream) and B5 (i2t_block_step): the kernels,
// what bounds them on the card and how they answer it are in
// twoway_attention.cuh, which decode_chunk.cu (B16) shares.
#include "twoway_attention.cuh"

using namespace iuvl;
using namespace iuvl::twoway;

// q: (B, T, 128) bf16, pre-scaled by 16^-0.5; keys: (Bk, N, 256) bf16 with
// Bk 1 or B; pe_wk: (N, 128) bf16; wk, wv: (128, 256) bf16 (out, in); bk,
// bv: (128) bf16; out: (B, T, 128) bf16. Scratch from the wrapper: kpv
// (N, 256) bf16 (batch-1 keys with B > 1 only), part_o (B, splits, T, 128)
// and part_ml (B, splits, T, 8, 2) fp32. Any T >= 1 and N >= 1; the key
// tiles (64 keys) split into `splits` ranges of ceil(tiles / splits), none
// empty (the wrapper's t2i_plan).
extern "C" int iuvl_t2i_stream(const void* q, const void* keys, const void* pe_wk, const void* wk,
                               const void* bk, const void* wv, const void* bv, void* out,
                               void* kpv, void* part_o, void* part_ml, int batch, int keys_batch,
                               int n, int tokens, int splits, void* stream) {
  return t2i_stream_run(static_cast<const bf16*>(q), static_cast<const bf16*>(keys),
                        static_cast<const bf16*>(pe_wk), static_cast<const bf16*>(wk),
                        static_cast<const bf16*>(bk), static_cast<const bf16*>(wv),
                        static_cast<const bf16*>(bv), static_cast<bf16*>(out),
                        static_cast<bf16*>(kpv), static_cast<float*>(part_o),
                        static_cast<float*>(part_ml), batch, keys_batch, n, tokens, splits,
                        static_cast<cudaStream_t>(stream));
}

// keys: (Bk, N, 256) bf16 with Bk 1 or B; pe_wq: (N, 128) bf16; kp, vp:
// (B, T, 128) bf16; wq: (128, 256) and wo: (256, 128) bf16 (out, in); bq:
// (128) and bo: (256) bf16; ln_w, ln_b: (256) fp32; out: (B, N, 256) bf16.
// Any T >= 1 and N >= 1.
extern "C" int iuvl_i2t_block_step(const void* keys, const void* pe_wq, const void* kp,
                                   const void* vp, const void* wq, const void* bq, const void* wo,
                                   const void* bo, const void* ln_w, const void* ln_b, void* out,
                                   int batch, int keys_batch, int n, int tokens, float scale,
                                   float eps, void* stream) {
  return i2t_block_run<false>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(pe_wq),
      static_cast<const bf16*>(kp), static_cast<const bf16*>(vp), tokens * kI,
      static_cast<const bf16*>(wq), static_cast<const bf16*>(bq), static_cast<const bf16*>(wo),
      static_cast<const bf16*>(bo), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(out), batch, keys_batch, n, tokens,
      scale, eps, static_cast<cudaStream_t>(stream));
}
