// Flash attention past the clusters' reach, the split route (flash_split.cuh
// documents the design): the scores kernel and the P V kernel of each type
// (fp32 in 3xTF32, bf16 and fp16 on wgmma; one P V instance for each column
// group width), reached from the wrapper (kernels/flash_attention/ops.py:
// flash_attention_split_cuda) for fp32 past D = 2,048 and bf16 and fp16 past
// 1,792, once a piece. The entries of flash_attention.cu and
// flash_attention_sm90*.cu refuse those head dims: this route needs the
// workspace the wrapper allocates.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas), which takes any D.
#include "flash_split.cuh"

// One piece (the query tiles t0 .. t0 + nt - 1 of the (batch, head) rows bh0
// .. bh0 + nbh - 1; ops.split_pieces) of the call: q, k, v, o of the type
// dtype (0 = bf16, 1 = fp16, 2 = fp32), fp32 lse (null: not written), the
// workspace ws (nbh nt 128 rows of ld fp32 scores, ld a multiple of 128 and
// at least Skv) and maxes (the same rows of ld / 64 floats); D > 256, a
// multiple of 8 (16 bits) or 4 (fp32); window <= 0 means no window. Two
// launches on the stream; returns the first error (cudaErrorInvalidValue for
// arguments outside these).
extern "C" int flash_attention_split(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse, void* ws,
                                     void* maxes, int B, int Sq, int Skv, int H,
                                     int KV, int D, int causal, int window,
                                     float scale, int bh0, int nbh, int t0, int nt,
                                     int ld, void* stream) {
  if (D <= kMaxWidth || D % (dtype == 2 ? 4 : 8) || Skv < 1 || ld < Skv ||
      ld % split::kKeyPad || nbh < 1 || nt < 1 || bh0 < 0 || bh0 + nbh > B * H ||
      t0 < 0 || (t0 + nt - 1) * kRows >= Sq)
    return cudaErrorInvalidValue;
  const split::Piece p = {q, k, v, o, lse, static_cast<float*>(ws),
                          static_cast<float*>(maxes), B, Sq, Skv, H, KV, D, causal,
                          window, scale, bh0, nbh, t0, nt, ld,
                          static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return split::piece_16<__nv_bfloat16>(p);
    case 1: return split::piece_16<__half>(p);
    case 2: return split::piece_32(p);
    default: return cudaErrorInvalidValue;
  }
}

// The instances that take head dim D in dtype: out[0..3] the scores
// kernel's registers a thread, local (spill) bytes a thread, static and
// dynamic shared bytes a CTA; out[4..7] the same of the P V kernel of D's
// group width.
extern "C" int flash_attention_split_attrs(int dtype, int D, int* out) {
  if (D <= kMaxWidth) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return split::attrs_16<__nv_bfloat16>(D, out);
    case 1: return split::attrs_16<__half>(D, out);
    case 2: return split::attrs_32(D, out);
    default: return cudaErrorInvalidValue;
  }
}
