// One VLG Up stage forward, with an optional 1-channel head, for Hopper
// (sm_90a).
//
// Replaces semivl_tpu/ops/fused_up.py::_up_fused_kernel (the Pallas TPU
// kernel behind fused_up_stage): per class plane, after the 2x2 stride-2
// transpose conv, conv3x3 over [up(x), skip] in split form (the skip half
// once per image, read for plane p as image p / N) -> GroupNorm (Cout / 16
// groups) -> ReLU -> conv3x3 -> GroupNorm -> ReLU, and with a head the 3x3
// head conv to one channel plus bias. Storage between the convs is bf16;
// accumulation and GroupNorm statistics are float32 (double for the final
// reduction).
//
// What bounds it on this card: at the flagship stage shapes (P = 294 planes
// of 14 images; up1 128 -> 64 channels at 64^2, up2 64 -> 32 at 128^2) it
// does about 254 GFLOP per stage (the transpose conv, both 3x3 convs and
// the per-image skip conv) on 235 and 470 MB of inputs and outputs, about
// 1000 and 540 flops per byte: bound by operations.
// This first version computes on the CUDA cores in float32 with the tile
// kernels of decoder_common.cuh (the same device code as the decoder
// kernels in fused_decoder.cu); tensor-core implicit GEMM is later work.
//
// Design against the TPU kernel. The TPU kernel ran one program per plane
// with the whole plane and conv1's output in VMEM, the transpose conv left
// to XLA. A plane at 128^2 x 32 channels is 1 MB in bf16, more than a
// block's shared memory, and blocks run in parallel, so the stage is a
// short sequence of tile kernels over (16x16 output tile, plane) blocks:
//   1. tconv2x2: up = x (*) W + b (float32 sum, one bf16 rounding, as
//      XLA's einsum with a float32 result cast once), here on the card too;
//   2. conv3x3 on the skip, once per IMAGE, float32;
//   3. conv3x3 over up, plus the skip term of the plane's image -> raw
//      conv1 (bf16) and per-(plane, group, tile) partial sums;
//   4. conv3x3 over GN1+ReLU(conv1), applied on load -> raw conv2 + sums;
//   5. GN2+ReLU(conv2) as its own pass (bf16 out), or with the head, the
//      head conv over GN2+ReLU(conv2) applied on load, plus bias.
// GroupNorm statistics need the whole plane: each conv block writes its
// tile's (sum, sum of squares) per group (no atomics), and the consumer's
// prologue reduces the plane's partials in double. The statistics are
// those of the bf16-stored raw conv outputs, as in fused_decoder.cu; the
// TPU kernel took them from the float32 sums before the rounding.

#include "decoder_common.cuh"

// One Up stage over P = B * n_rep planes. Shapes (all NCHW, contiguous):
//   x (P, cin, h, w) bf16; skip (B, cs, 2h, 2w) bf16;
//   up_w float32 [cin][4][cu], up_b [cu];
//   w1u [cu][9][cout], w1s [cs][9][cout], w2 [cout][9][cout] float32;
//   g1w, g1b, g2w, g2b [cout]; head_w [cout][9][1], head_b [1], or null;
//   scratch: up (P, cu, 2h, 2w) bf16, ys (B, cout, 2h, 2w) float32, c1, c2
//     (P, cout, 2h, 2w) bf16, part1 / part2 (P, cout/16, tiles, 2);
//   out: GN2+ReLU(conv2) (P, cout, 2h, 2w) bf16, or with the head the
//     logits (P, 1, 2h, 2w) bf16.
// cout in {16, 32, 64}, cin a multiple of 32, cu of 16. Returns
// cudaGetLastError() after the launches.
extern "C" int up_stage_fwd(const void* x, int P, int cin, int h, int w, const void* skip,
                            int B, int cs, const void* up_w, const void* up_b, int cu,
                            const void* w1u, const void* w1s, const void* w2, int cout,
                            const void* g1w, const void* g1b, const void* g2w, const void* g2b,
                            const void* head_w, const void* head_b, void* up, void* ys, void* c1,
                            void* part1, void* c2, void* part2, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int H = 2 * h, W = 2 * w;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const float inv_out = 1.f / (GSIZE * (float)H * (float)W);
  const GNIn none = NO_GN;

  tconv2x2_kernel<<<dim3(tiles, P, cu / CU_T), NT, 0, st>>>(
      (const bf16*)x, cin, h, w, none, (const float*)up_w, (const float*)up_b, cu, (bf16*)up);
  conv(cout, (const bf16*)skip, B, cs, H, W, none, (const float*)w1s, nullptr, nullptr, 1,
       nullptr, (float*)ys, nullptr, st);
  conv(cout, (const bf16*)up, P, cu, H, W, none, (const float*)w1u, nullptr, (const float*)ys,
       P / B, (bf16*)c1, nullptr, (float*)part1, st);
  const GNIn gn1{(const float*)part1, (const float*)g1w, (const float*)g1b, tiles, inv_out};
  conv(cout, (const bf16*)c1, P, cout, H, W, gn1, (const float*)w2, nullptr, nullptr, 1,
       (bf16*)c2, nullptr, (float*)part2, st);
  const GNIn gn2{(const float*)part2, (const float*)g2w, (const float*)g2b, tiles, inv_out};
  if (head_w != nullptr) {
    conv(1, (const bf16*)c2, P, cout, H, W, gn2, (const float*)head_w, (const float*)head_b,
         nullptr, 1, (bf16*)out, nullptr, nullptr, st);
  } else {
    gn_relu_kernel<<<dim3((H * W + NT - 1) / NT, P), NT, 0, st>>>((const bf16*)c2, cout, H * W,
                                                                   gn2, (bf16*)out);
  }
  return (int)cudaGetLastError();
}
