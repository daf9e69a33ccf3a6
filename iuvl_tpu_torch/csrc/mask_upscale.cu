// The C entry of B6 (masks_upscale): the kernel, what bounds it on the
// card and how it answers it are in mask_upscale.cuh, which
// decode_chunk.cu (B16) shares.
#include "mask_upscale.cuh"

using namespace iuvl;

// keys: (B, HW, 256) bf16; w1: (256, 256) bf16, cols (di, dj, co); b1: (64)
// bf16; lnw, lnb: (64) fp32; w2: (64, 128) bf16, cols (ei, ej, co); b2: (32)
// bf16; hyper: (B, 4, 32) bf16; out: (B, HW, 64) bf16, cols (t, di, ei, dj, ej).
// Any HW >= 1.
extern "C" int iuvl_masks_upscale(const void* keys, const void* w1, const void* b1,
                                  const void* lnw, const void* lnb, const void* w2,
                                  const void* b2, const void* hyper, void* out, int batch,
                                  int hw, void* stream) {
  return upscale::masks_upscale_run<false>(
      static_cast<const bf16*>(keys), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(hyper), out, batch, hw,
      static_cast<cudaStream_t>(stream));
}
