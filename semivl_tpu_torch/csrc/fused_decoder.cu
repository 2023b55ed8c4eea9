// Fused VLG decoder Up stage forward for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels: semivl_tpu/ops/fused_decoder.py::
// _stage_fwd_kernel (behind fused_vlg_decoder; #5) and semivl_tpu/ops/
// fused_up.py::_up_fused_kernel (behind fused_up_stage; #11). Per class
// plane: the 2x2 stride-2 transpose conv, conv1 3x3 over [up(x), skip],
// GroupNorm -> ReLU -> conv2 3x3 -> GroupNorm -> ReLU, and on the last
// stage the 3x3 head to one channel with bias. Storage between the convs
// is bf16; accumulation and GroupNorm statistics are float32 (double for
// the final reduction).
//
// What bounds it on this card: the flagship decoder (P = 42 planes, x
// 128x32x32 -> 1x128x128) does about 72 GFLOP on about 15 MB of inputs and
// outputs, and the fused Up stage at P = 294 about 254 GFLOP per stage on
// 235-470 MB, so both are bound by operations: the tensor cores. The stage
// is decoder_stage_bwd.cuh's stage_recompute, the sequence both decoder
// backward routes recompute their stage with, on decoder_igemm.cuh's wgmma
// implicit GEMM (bf16 operands, float32 sums, TMA rings): the transpose
// conv per output phase (in column groups of at most 128 channels), conv1's
// skip half once per image (the skip is shared by the N class planes of an
// image) as the float32 addend of its up half's epilogue, GroupNorm
// partials of the stored raw conv1 and conv2 in their epilogues, GN1+ReLU
// as its own pass, conv2. The head (K = 9 Cout, one output channel) stays
// on decoder_common.cuh's CUDA cores, GN2+ReLU applied as it loads raw
// conv2.
//
// The stage ends in one of three ways, chosen by the slots that are set:
// the head's logits (S_HEAD_W); GN2+ReLU(raw conv2) as its own pass into
// S_OUT (the fused Up stage without a head); or, with neither, the raw
// conv2 and its GroupNorm partials for the next stage. That stage first
// runs GN+ReLU of its input as its own pass into a bf16 copy
// (gn_relu_kernel, as the whole-plane backward's recompute does), then the
// stage. The copy costs one read and one write of the input plane (stage
// 2's input is a quarter of its output plane); folding the normalisation
// into the transpose conv's TMA source instead would need a
// GroupNorm-applying copy there all the same, since TMA loads raw bytes.
//
// GroupNorm statistics need the whole plane: each conv tile (4 rows x 64
// pixels) writes its (sum, sum of squares) per group (no atomics), and the
// consumer's prologue reduces the plane's partials in double in tile
// order. decoder_gn_stats reduces the same partials in the same order for
// the banded backward.
//
// Design against the TPU kernels. They ran one program per plane with the
// whole plane and conv1's output in VMEM. A plane at 128^2 x 32 channels is
// 1 MB in bf16, more than a block's shared memory, and blocks run in
// parallel, so the stage is a short sequence of kernels over whole planes.
// The statistics are those of the bf16-stored raw conv outputs; the fused
// Up stage's TPU kernel took them from the float32 sums before the
// rounding.

#include "decoder_stage_bwd.cuh"

namespace {

// Tensor slots of decoder_stage_fwd (t[]) and its sizes (d[]).
// D_SKIP_HALF: 1 (0 leaves conv1's skip half out, a planted fault).
enum StageSlot {
  S_X, S_GN_PART, S_GN_GAMMA, S_GN_BETA, S_SKIP, S_UP_WF, S_UP_B, S_W1U, S_W1S, S_W2, S_G1W,
  S_G1B, S_G2W, S_G2B, S_HEAD_W, S_HEAD_B, S_XIN, S_UP, S_YS, S_C1, S_PART1, S_A1, S_C2,
  S_PART2, S_SCR, S_OUT, S_COUNT
};
// D_GS, D_GS_IN: channels per GroupNorm group of the output and of a
// normalised input (16 but where a group lies zero-padded: GNIn::gk).
enum Dim {
  D_P, D_CIN, D_H, D_W, D_GN_NPARTS, D_B, D_CS, D_CU, D_COUT, D_SKIP_HALF, D_GS, D_GS_IN,
  D_COUNT
};

}  // namespace

// One Up stage over P = B * n_rep planes, ending in the head when
// S_HEAD_W is set, else in GN2+ReLU when S_OUT is set. Inputs (NCHW,
// contiguous): x (P, cin, h, w) bf16, still raw when S_GN_PART is set:
// GN+ReLU by the previous stage's conv2 partials (S_GN_PART [P][cin / 16]
// [D_GN_NPARTS][2], S_GN_GAMMA, S_GN_BETA [cin] float32) into S_XIN (P,
// cin, h, w) bf16 first; skip (B, cs, 2h, 2w) bf16; the weights in the
// igemm layouts (bf16): S_UP_WF per column group of the up channels
// [4][group][cin] (phase ky * 2 + kx; stage_recompute), S_W1U [9][cout]
// [cu], S_W1S [9][cout][cs], S_W2 [9][cout][cout]; float32 S_UP_B [cu],
// S_G1W, S_G1B, S_G2W, S_G2B [cout]; with the head S_HEAD_W float32 [cout]
// [9][1] and S_HEAD_B [1]. Outputs: S_C2 raw conv2 (P, cout, 2h, 2w) bf16
// and its partials S_PART2; S_C1 raw conv1 and S_PART1; S_OUT, with the
// head the logits (P, 1, 2h, 2w) bf16, else GN2+ReLU(raw conv2) (P, cout,
// 2h, 2w) bf16. The partials are (P, cout / 16, tiles, 2) float32 with
// tiles = ceil(2h / 4) ceil(2w / 64). Scratch: S_UP (P, cu, 2h, 2w) bf16;
// S_YS (B, cout, 2h, 2w) float32; S_A1 (P, cout, 2h, 2w) bf16; S_SCR
// bf16, room for the three column-shifted copies of the widest source (3 P
// max(cin, cu, cs, cout) 2h tma_pitch(2w)). cin, cs, cu and cout
// multiples of 16, at most 512 for a normalised width. Returns the first
// CUDA error of the launches.
extern "C" int decoder_stage_fwd(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], cout = d[D_COUT];
  const int H = 2 * h, W = 2 * w;
  const int tiles = ((H + igemm::CONV_ROWS - 1) / igemm::CONV_ROWS) *
                    ((W + igemm::TW - 1) / igemm::TW);
  if ((t[S_GN_PART] != nullptr && cin > GSIZE * MAXG) || cout > GSIZE * MAXG)
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };

  const bf16* xin = b16(S_X);
  if (t[S_GN_PART] != nullptr) {
    const GNIn gx = gn_parts(f(S_GN_PART), f(S_GN_GAMMA), f(S_GN_BETA), d[D_GN_NPARTS],
                             d[D_GS_IN], h, w);
    gn_relu_kernel<<<dim3((h * w + NT - 1) / NT, P), NT, 0, st>>>(b16(S_X), cin, h * w, gx,
                                                                   b16(S_XIN));
    xin = b16(S_XIN);
  }
  const Stage s{P, cin, h, w, d[D_B], d[D_CS], d[D_CU], cout};
  const GNIn gn1 = gn_parts(f(S_PART1), f(S_G1W), f(S_G1B), tiles, d[D_GS], H, W);
  Planes a1;
  SEMIVL_CK(stage_recompute(s, xin, b16(S_SKIP), b16(S_UP_WF), f(S_UP_B), b16(S_W1U),
                            b16(S_W1S), b16(S_W2), d[D_SKIP_HALF] != 0, gn1, b16(S_UP),
                            f(S_YS), b16(S_C1), f(S_PART1), b16(S_A1), b16(S_C2), f(S_PART2),
                            b16(S_SCR), &a1, st));
  const GNIn gn2 = gn_parts(f(S_PART2), f(S_G2W), f(S_G2B), tiles, d[D_GS], H, W);
  if (t[S_HEAD_W] != nullptr)
    SEMIVL_CK(conv(1, b16(S_C2), P, cout, H, W, gn2, f(S_HEAD_W), f(S_HEAD_B), b16(S_OUT), st));
  else if (t[S_OUT] != nullptr)
    gn_relu_kernel<<<dim3((H * W + NT - 1) / NT, P), NT, 0, st>>>(b16(S_C2), cout, H * W, gn2,
                                                                   b16(S_OUT));
  return (int)cudaGetLastError();
}

namespace {

// mean, rstd [P][chunks * GSIZE] from a conv's partials [P][chunks][nparts]
// [2] in groups of gk chunks: one thread per (plane, chunk), the
// prologue's own reduction.
__global__ void gn_stats_kernel(const float* __restrict__ part, int P, int chunks, int nparts,
                                GNIn gn, float* __restrict__ mean, float* __restrict__ rstd) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P * chunks) return;
  float m, r;
  const int first = i / chunks * chunks + i % chunks / gn.gk * gn.gk;
  gn_group_stats(part + (size_t)first * nparts * 2, gn.gk * nparts, gn.inv_count, &m, &r);
  for (int c = 0; c < GSIZE; ++c) {
    mean[(size_t)i * GSIZE + c] = m;
    rstd[(size_t)i * GSIZE + c] = r;
  }
}

}  // namespace

// The GroupNorm statistics that decoder_stage_fwd normalised with, for the
// banded backward: from the partials part1 or part2 (P, C / 16, nparts, 2)
// of a stage whose conv output is (P, C, H, W) in groups of gs channels,
// mean and rstd (P, C) float32 (each group's value on its chunks'
// channels), bit-identical to the forward's prologue. Returns
// cudaGetLastError() after the launch.
extern "C" int decoder_gn_stats(const void* part, int P, int C, int nparts, int H, int W,
                                int gs, void* mean, void* rstd, void* stream) {
  const GNIn gn = gn_parts(nullptr, nullptr, nullptr, nparts, gs, H, W);   // as decoder_stage_fwd
  const int n = P * (C / GSIZE);
  gn_stats_kernel<<<(n + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      (const float*)part, P, C / GSIZE, nparts, gn, (float*)mean, (float*)rstd);
  return (int)cudaGetLastError();
}
