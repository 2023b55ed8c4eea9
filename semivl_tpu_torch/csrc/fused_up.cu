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
// 1000 and 540 flops per byte: bound by operations, so the tensor cores.
// The stage is decoder_stage_bwd.cuh's stage_recompute, the sequence that
// both decoder backward routes recompute their stage with, on
// decoder_igemm.cuh's wgmma implicit GEMM (bf16 operands, float32 sums,
// TMA rings): the transpose conv per output phase (in column groups of at
// most 128 channels), conv1's skip half once per image as the float32
// addend of its up half's epilogue, GroupNorm partials of the stored raw
// conv1 and conv2 in their epilogues, GN1+ReLU as its own pass, conv2.
// Then GN2+ReLU as its own pass (bf16 out), or with the head the head conv
// over GN2+ReLU(conv2) applied on load, plus bias: a product to one
// channel (K = 9 Cout, about 1.4 GFLOP a stage), on decoder_common.cuh's
// CUDA cores.
//
// Widths: the products take N (output channels) in 16, 32, 48, 64, 96 or
// 128 and K (input channels) in multiples of 16. The wrapper
// (ops/fused_up.py, with ops/fused_decoder.py::stage_plan) zero-pads the
// skip channels to a multiple of 16 and the up channels to a width whose
// column groups are such N; zeros add nothing, so the arithmetic is that of
// the true widths.
//
// Design against the TPU kernel. The TPU kernel ran one program per plane
// with the whole plane and conv1's output in VMEM, the transpose conv left
// to XLA. A plane at 128^2 x 32 channels is 1 MB in bf16, more than a
// block's shared memory, and blocks run in parallel, so the stage is a
// short sequence of kernels over whole planes. GroupNorm statistics need
// the whole plane: each conv tile writes its (sum, sum of squares) per
// group (no atomics), and the consumer's prologue reduces the plane's
// partials in double. The statistics are those of the bf16-stored raw conv
// outputs, as in the decoder's kernels; the TPU kernel took them from the
// float32 sums before the rounding.

#include "decoder_stage_bwd.cuh"

namespace {

// Tensor slots of up_stage_fwd (t[]) and its sizes (d[]). D_SKIP_HALF: 1
// (0 leaves conv1's skip half out, a planted fault).
enum UpSlot {
  U_X, U_SKIP, U_UP_WF, U_UP_B, U_W1U, U_W1S, U_W2, U_G1W, U_G1B, U_G2W, U_G2B, U_HEAD_W,
  U_HEAD_B, U_UP, U_YS, U_C1, U_PART1, U_A1, U_C2, U_PART2, U_SCR, U_OUT, U_COUNT
};
enum Dim { D_P, D_CIN, D_H, D_W, D_B, D_CS, D_CU, D_COUT, D_SKIP_HALF, D_COUNT };

}  // namespace

// One Up stage over P = B * n_rep planes. Inputs (NCHW, contiguous): x (P,
// cin, h, w) bf16; skip (B, cs, 2h, 2w) bf16; the weights in the igemm
// layouts (bf16): U_UP_WF per group of 128 up channels [4][group][cin]
// (phase ky * 2 + kx), U_W1U [9][cout][cu], U_W1S [9][cout][cs], U_W2 [9]
// [cout][cout]; float32 U_UP_B [cu], U_G1W, U_G1B, U_G2W, U_G2B [cout];
// with the head U_HEAD_W float32 [cout][9][1] and U_HEAD_B [1]. Output
// U_OUT: GN2+ReLU(conv2) (P, cout, 2h, 2w) bf16, or with the head the
// logits (P, 1, 2h, 2w) bf16. Scratch: U_UP (P, cu, 2h, 2w) bf16; U_YS (B,
// cout, 2h, 2w) float32; U_C1, U_A1, U_C2 (P, cout, 2h, 2w) bf16; U_PART1,
// U_PART2 (P, cout / 16, tiles, 2) float32 with tiles = ceil(2h / 4)
// ceil(2w / 64); U_SCR bf16, room for the three column-shifted copies of
// the widest source (3 P max(cin, cu, cs, cout) 2h tma_pitch(2w)). cout in
// {16, 32, 64}, cin, cs and cu multiples of 16, cu in column groups of
// 16, 32, 48, 64, 96 or 128. Returns the first CUDA error of the launches.
extern "C" int up_stage_fwd(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], h = d[D_H], w = d[D_W], cout = d[D_COUT];
  const int H = 2 * h, W = 2 * w, HW = H * W;
  const int tiles = ((H + igemm::CONV_ROWS - 1) / igemm::CONV_ROWS) *
                    ((W + igemm::TW - 1) / igemm::TW);
  const float inv_out = 1.f / (GSIZE * (float)H * (float)W);
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const Stage s{P, d[D_CIN], h, w, d[D_B], d[D_CS], d[D_CU], cout};
  const GNIn gn1{f(U_PART1), f(U_G1W), f(U_G1B), tiles, inv_out};
  const GNIn gn2{f(U_PART2), f(U_G2W), f(U_G2B), tiles, inv_out};

  Planes a1;
  SEMIVL_CK(stage_recompute(s, b16(U_X), b16(U_SKIP), b16(U_UP_WF), f(U_UP_B), b16(U_W1U),
                            b16(U_W1S), b16(U_W2), d[D_SKIP_HALF] != 0, gn1, b16(U_UP),
                            f(U_YS), b16(U_C1), f(U_PART1), b16(U_A1), b16(U_C2), f(U_PART2),
                            b16(U_SCR), &a1, st));
  if (t[U_HEAD_W] != nullptr)
    conv(1, (const bf16*)b16(U_C2), P, cout, H, W, gn2, f(U_HEAD_W), f(U_HEAD_B), nullptr, 1,
         b16(U_OUT), nullptr, nullptr, st);
  else
    gn_relu_kernel<<<dim3((HW + NT - 1) / NT, P), NT, 0, st>>>(b16(U_C2), cout, HW, gn2,
                                                                b16(U_OUT));
  return (int)cudaGetLastError();
}
