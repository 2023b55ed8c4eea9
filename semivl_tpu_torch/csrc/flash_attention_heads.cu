// Head-split multi-head self-attention forward, and the backward of both
// attention routes, for Hopper (sm_90a).
//
// Replaces semivl_tpu/ops/flash_attention.py::_fwd_kernel and ::_bwd_kernel
// (the Pallas TPU kernels behind flash_mha's head-split route, taken for
// heads whose width is not 64 or whose count is odd): softmax(q k^T /
// sqrt(D)) v per head of D a multiple of 16 up to 128 (the TPU kernels
// take any width; ops/flash_attention.py zero-pads a narrower width that
// is not a multiple of 16 to the next one and passes the true width's
// scales; the repo's models have heads of 16, 32 and 64), keys at or past
// valid_len masked to -1e30, and its gradient. A width above 128 (still
// a multiple of 16 after the same padding) runs attention_wide.cuh's
// CUDA-core kernels, which take any such width. The backward at D =
// 64 also replaces ::_packed_bwd_kernel: the packed forward
// (flash_attention.cu) writes the same row log-sum-exp, and at D = 64 the
// two TPU backwards compute one function (1/8 is exact in bf16, so dk from
// the scaled q equals dk from q scaled after the product).
//
// What bounds it on this card: 4 B H L^2 D flops on 8 B L C bytes of q, k,
// v and out, so L / 2 flops per byte: the tiny VLM's L = 17 and 21 are
// bound by bytes (and by launch latency), the encoder widths (L >= 1025)
// by the tensor cores, the forward's exponentials close behind (it takes
// two per score, one in each pass).
//
// Design against the TPU kernels. They split the heads out of the (B, L,
// C) arrays into (B*H, L, D) copies and kept a head's whole K/V in VMEM;
// here q, k and v are read in place as views of the one (B, L, 3C) in_proj
// output (row stride 3C, head h at column h*D), and K/V stream through
// shared memory in tiles (a head's K and V at L = 2602, D = 128 are 1.3
// MB, more than a block's 227 KB). Rows and keys past L are zero-filled on
// load; keys past valid_len are masked in the softmax.
//
// Forward: the two-pass instance of attention_fwd.cuh (TMA ring of
// 128-key tiles, wgmma, the softmax in registers). The TPU forward
// normalises p before casting it to bf16 for p v; so does this one: pass 1
// finds each row's max and sum of exp (online, float32) from q k^T alone,
// pass 2 forms p = exp(s - max) / sum, rounds it to bf16 and accumulates
// p v with no rescale. It rounds exactly where JAX does (q times the bf16
// scale, p, the output) at the cost of computing q k^T twice; the packed
// kernel (flash_attention.cu) rounds the unnormalised p instead. The
// forward also writes each row's log-sum-exp when autograd needs it.
//
// Backward: attention_bwd.cuh (a prep kernel for delta and the scaled q,
// then one TMA + wgmma kernel for dk and dv and one for dq, without float
// atomics, so reruns agree bit for bit). It takes p = exp(s - lse) from
// the forward's log-sum-exp (the TPU backward recomputed the full-row
// softmax) and rounds p and ds to bf16 before their products as the TPU
// kernel does:
//   dv = p^T dO, dk = ds^T q / sqrt(D), dq = ds k / sqrt(D).

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "attention_wide.cuh"

// q, k, v: bf16 (B, L, H*D) views sharing strides (batch, row) with unit
// column stride and 16-byte aligned rows, D a multiple of 16 (16, 32, ...,
// 128 on the tensor cores, wider on attention_wide.cuh's); out: bf16
// with its own strides; lse: null, or float32 (B, H, L) for each row's
// log-sum-exp of the scaled scores. qscale: 1/sqrt(D) as a bf16 value (q is
// multiplied by it and rounded to bf16 before q k^T). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another D).
extern "C" int heads_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int L, int H, int D, int valid_len,
                                   long long in_bstride, long long in_rstride,
                                   long long out_bstride, long long out_rstride, float qscale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEMIVL_HEADS_FWD(N)                                                                  \
  case N:                                                                                    \
    return attention_fwd::launch<N, true>(q, k, v, out, lse, B, L, H, valid_len, in_bstride, \
                                          in_rstride, out_bstride, out_rstride, qscale, st);
  switch (D) {
    SEMIVL_HEADS_FWD(16)
    SEMIVL_HEADS_FWD(32)
    SEMIVL_HEADS_FWD(48)
    SEMIVL_HEADS_FWD(64)
    SEMIVL_HEADS_FWD(80)
    SEMIVL_HEADS_FWD(96)
    SEMIVL_HEADS_FWD(112)
    SEMIVL_HEADS_FWD(128)
  }
#undef SEMIVL_HEADS_FWD
  return wide_attention::launch_fwd(q, k, v, out, lse, B, L, H, D, valid_len, in_bstride,
                                    in_rstride, out_bstride, out_rstride, qscale, st);
}

// Backward of heads_attention_fwd, and at D = 64 of packed_attention_fwd
// (flash_attention.cu). q, k, v: the forward's bf16 views (in_*
// strides); o: its output and g: bf16 dO, both with the g_* strides; lse:
// the forward's float32 (B, H, L) output; delta: float32 (B, H, L) scratch;
// dq, dk, dv: bf16 outputs sharing the d_* strides, e.g. the column thirds
// of one (B, L, 3C) buffer (dq also holds q times qscale between the
// launches, so it must not alias q, k, v, o or g). qscale: as the
// forward's; gscale: 1/sqrt(D) in float32, the factor of dq and dk. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for another
// D, or for views a tensor map cannot describe).
extern "C" int heads_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int L, int H, int D,
                                   int valid_len, long long in_bstride, long long in_rstride,
                                   long long g_bstride, long long g_rstride,
                                   long long d_bstride, long long d_rstride, float qscale,
                                   float gscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEMIVL_HEADS_BWD(N)                                                                   \
  case N:                                                                                     \
    return attention_bwd::launch<N>(q, k, v, o, g, lse, delta, dq, dk, dv, B, L, H,          \
                                    valid_len, in_bstride, in_rstride, g_bstride, g_rstride,  \
                                    d_bstride, d_rstride, qscale, gscale, st);
  switch (D) {
    SEMIVL_HEADS_BWD(16)
    SEMIVL_HEADS_BWD(32)
    SEMIVL_HEADS_BWD(48)
    SEMIVL_HEADS_BWD(64)
    SEMIVL_HEADS_BWD(80)
    SEMIVL_HEADS_BWD(96)
    SEMIVL_HEADS_BWD(112)
    SEMIVL_HEADS_BWD(128)
  }
#undef SEMIVL_HEADS_BWD
  return wide_attention::launch_bwd(q, k, v, o, g, lse, delta, dq, dk, dv, B, L, H, D,
                                    valid_len, in_bstride, in_rstride, g_bstride, g_rstride,
                                    d_bstride, d_rstride, qscale, gscale, st);
}
