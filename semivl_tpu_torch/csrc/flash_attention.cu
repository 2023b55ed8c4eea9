// Packed multi-head self-attention forward for Hopper (sm_90a). Its
// backward is heads_attention_bwd at D = 64 (flash_attention_heads.cu),
// from the row log-sum-exp this kernel writes under autograd.
//
// Replaces semivl_tpu/ops/flash_attention.py::_packed_fwd_kernel (the
// Pallas TPU kernel behind flash_mha's packed path): softmax(q k^T / 8) v
// per head of 64, read straight from the (B, L, C) rows so no head
// transposes are materialised, float32 softmax, keys at or past valid_len
// masked to -1e30.
//
// What bounds it on this card: at the encoder shapes (B = 2, 12 heads) it
// does 4 B H L^2 64 flops on 8 B L C bytes, about 690 flops a byte at
// L = 1025 and 1650 at L = 2602, so the tensor cores bound it (0.0065 ms
// and 0.042 ms), with the exponentials (one per score on the
// special-function units) close behind. The TPU kernel kept a head's whole
// K/V in VMEM; here they stream through a TMA ring in 128-key tiles under
// an online float32 softmax held in registers, both products on wgmma
// (attention_fwd.cuh, the one pass of its core).
//
// Numerics against the TPU kernel: it normalises p before casting it to
// bf16 for p v; here the unnormalised p (in (0, 1], against the running
// max of its tile) is cast and the sum is divided out at the end in
// float32. Both round p once to bf16, so the two differ by about one bf16
// ulp of the output (2^-8 relative). ops/flash_attention.py::_fwd_rounded
// is this kernel's arithmetic, over the same 128-key tiles.

#include "attention_fwd.cuh"

// q, k, v: bf16 (B, L, H*64) views sharing strides (batch, row) with unit
// column stride and 16-byte aligned rows; out: bf16 with its own strides;
// lse: null, or float32 (B, H, L) for each row's log-sum-exp of the scaled
// scores (what heads_attention_bwd needs to rebuild the probabilities).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue if a
// tensor map cannot describe the views).
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int B, int L, int H,
                                    int valid_len, long long in_bstride,
                                    long long in_rstride, long long out_bstride,
                                    long long out_rstride, float scale, void* stream) {
  return attention_fwd::launch<64, false>(q, k, v, out, lse, B, L, H, valid_len, in_bstride,
                                          in_rstride, out_bstride, out_rstride, scale,
                                          (cudaStream_t)stream);
}
