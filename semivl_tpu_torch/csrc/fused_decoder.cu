// Fused VLG decoder Up stage forward for Hopper (sm_90a).
//
// Replaces semivl_tpu/ops/fused_decoder.py::_stage_fwd_kernel (the Pallas
// TPU kernel behind fused_vlg_decoder): per class plane, the 2x2 stride-2
// transpose conv, conv1 3x3 over [up(x), skip], GroupNorm -> ReLU ->
// conv2 3x3 -> GroupNorm -> ReLU, and on the last stage the 3x3 head to one
// channel with bias. Storage between the convs is bf16; accumulation and
// GroupNorm statistics are float32 (double for the final reduction).
//
// What bounds it on this card: the flagship decoder (P = 42 planes, x
// 128x32x32 -> 1x128x128) does about 72 GFLOP on about 15 MB of inputs and
// outputs, so it is bound by operations. This first version computes on the
// CUDA cores in float32 (register-tiled direct convolution: each thread owns
// one output pixel and all output channels, weights stream through shared
// memory as float4 broadcasts), which is right but far from the tensor-core
// bound; implicit GEMM on the tensor cores is later work.
//
// Design against the TPU kernel. The TPU kernel kept a whole plane in VMEM
// (megabytes) and ran the grid in order; a stage-2 plane is 32x128x128, 1 MB
// per conv output in bf16, more than a block's shared memory, and blocks
// run in parallel. So one stage is a short sequence of kernels on the
// stream, each over (16x16 output tile, plane) blocks:
//   1. tconv2x2: up = x (*) W + b, bf16. The input may carry the previous
//      stage's GroupNorm+ReLU, applied as it is loaded.
//   2. conv3x3 on the skip, once per IMAGE (the skip is shared by the N
//      class planes of an image, as _SplitSkipConv computes it), float32.
//   3. conv3x3 over up, plus the skip term of the plane's image -> raw
//      conv1 output (bf16) and per-(plane, group, tile) partial sums.
//   4. conv3x3 over GN1+ReLU(conv1), applied on load -> raw conv2 + sums.
//   5. last stage only: the head conv over GN2+ReLU(conv2), plus bias.
// GroupNorm statistics need the whole plane: each conv block writes its
// tile's (sum, sum of squares) per group (no atomics), and the consumer's
// prologue reduces the plane's partials in double (the second pass). A
// stage that ends without the head hands its raw conv2 and partial sums to
// the next stage, whose tconv applies GN2+ReLU on load.

#include "decoder_common.cuh"

// One Up stage (plus the head when head_w is not null) over P = B * n_rep
// planes. Shapes (all NCHW, contiguous):
//   x (P, cin, h, w) bf16, optionally still raw: gn_part/gn_gamma/gn_beta
//     (the previous stage's conv2 partials) apply GN+ReLU on load;
//   skip (B, cs, 2h, 2w) bf16;
//   up_w float32 [cin][4][cu], up_b [cu];
//   w1u [cu][9][cout], w1s [cs][9][cout], w2 [cout][9][cout] float32;
//   g1w, g1b, g2w, g2b [cout]; head_w [cout][9][1], head_b [1];
//   scratch: up (P, cu, 2h, 2w) bf16, ys (B, cout, 2h, 2w) float32,
//     c1 (P, cout, 2h, 2w) bf16, part1 / part2 (P, cout/16, tiles, 2);
//   out: c2 raw (P, cout, 2h, 2w) bf16, or head logits (P, 1, 2h, 2w) bf16.
// cin, cs, cu and cout are multiples of 16 (cout in {16, 32, 64}, cin and cu
// of 32 for the transpose conv, cin, cs, cu and cout of 8 for the convs).
// Returns cudaGetLastError() after the launches.
extern "C" int decoder_stage_fwd(
    const void* x, int P, int cin, int h, int w, const void* gn_part, const void* gn_gamma,
    const void* gn_beta, int gn_nparts, const void* skip, int B, int cs, const void* up_w,
    const void* up_b, int cu, const void* w1u, const void* w1s, const void* w2, int cout,
    const void* g1w, const void* g1b, const void* g2w, const void* g2b, const void* head_w,
    const void* head_b, void* up, void* ys, void* c1, void* part1, void* part2, void* c2,
    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int H = 2 * h, W = 2 * w;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const float inv_in = 1.f / (GSIZE * (float)h * (float)w);
  const float inv_out = 1.f / (GSIZE * (float)H * (float)W);
  const GNIn none = NO_GN;

  GNIn gn_x{(const float*)gn_part, (const float*)gn_gamma, (const float*)gn_beta, gn_nparts,
            inv_in};
  tconv2x2_kernel<<<dim3(tiles, P, cu / CU_T), NT, 0, st>>>(
      (const bf16*)x, cin, h, w, gn_x, (const float*)up_w, (const float*)up_b, cu, (bf16*)up);
  conv(cout, (const bf16*)skip, B, cs, H, W, none, (const float*)w1s, nullptr, nullptr, 1,
       nullptr, (float*)ys, nullptr, st);
  conv(cout, (const bf16*)up, P, cu, H, W, none, (const float*)w1u, nullptr, (const float*)ys,
       P / B, (bf16*)c1, nullptr, (float*)part1, st);
  GNIn gn1{(const float*)part1, (const float*)g1w, (const float*)g1b, tiles, inv_out};
  conv(cout, (const bf16*)c1, P, cout, H, W, gn1, (const float*)w2, nullptr, nullptr, 1,
       (bf16*)c2, nullptr, (float*)part2, st);
  if (head_w != nullptr) {
    GNIn gn2{(const float*)part2, (const float*)g2w, (const float*)g2b, tiles, inv_out};
    conv(1, (const bf16*)c2, P, cout, H, W, gn2, (const float*)head_w, (const float*)head_b,
         nullptr, 1, (bf16*)out, nullptr, nullptr, st);
  }
  return (int)cudaGetLastError();
}

namespace {

// mean, rstd [P][groups * GSIZE] from a conv's partials [P][groups][nparts]
// [2]: one thread per (plane, group), the prologue's own reduction.
__global__ void gn_stats_kernel(const float* __restrict__ part, int P, int groups, int nparts,
                                float inv_count, float* __restrict__ mean,
                                float* __restrict__ rstd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * groups) return;
  float m, r;
  gn_group_stats(part + (size_t)i * nparts * 2, nparts, inv_count, &m, &r);
  for (int c = 0; c < GSIZE; ++c) {
    mean[(size_t)i * GSIZE + c] = m;
    rstd[(size_t)i * GSIZE + c] = r;
  }
}

}  // namespace

// The GroupNorm statistics that decoder_stage_fwd normalised with, for the
// banded backward: from the partials part1 or part2 of a stage whose conv
// output is (P, C, H, W), mean and rstd (P, C) float32 (each group's value
// on its GSIZE channels), bit-identical to the forward's prologue. Returns
// cudaGetLastError() after the launch.
extern "C" int decoder_gn_stats(const void* part, int P, int C, int H, int W, void* mean,
                                void* rstd, void* stream) {
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const float inv = 1.f / (GSIZE * (float)H * (float)W);   // as decoder_stage_fwd
  const int n = P * (C / GSIZE);
  gn_stats_kernel<<<(n + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const float*)part, P, C / GSIZE, tiles, inv, (float*)mean, (float*)rstd);
  return (int)cudaGetLastError();
}
