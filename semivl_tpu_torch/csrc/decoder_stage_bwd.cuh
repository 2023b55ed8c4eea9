// The tensor-core sequences of one decoder stage, shared by the decoder
// forward and the fused Up stage (fused_decoder.cu, kernels #5 and #11),
// the whole-plane backward (fused_decoder_bwd.cu, #6 and #7) and the banded
// backward (fused_decoder_banded.cu, passes A, B and C of #8-#10): every
// product of more than one channel on decoder_igemm.cuh's wgmma implicit
// GEMM, the elementwise passes and the head's convolutions to and from one
// channel (K = 9) on the CUDA cores of decoder_common.cuh.
//
//  - stage_recompute: the stage forward from its inputs (the transpose
//    conv per output phase, in column groups; conv1's skip half per image
//    as a float32 addend of its up half; GroupNorm+ReLU of raw conv1;
//    conv2), storing up, raw1 and raw2 in bf16; the decoder forward (#5),
//    the Up stage's forward (#11) and the recompute of both backward
//    routes;
//  - head_bwd: the head's input gradient g_a2 (bf16), weight gradient (the
//    wgrad kernel at N = 16, column 0 the logits' gradient) and bias
//    gradient;
//  - conv2_bwd: from g_raw2 (bf16), conv2's input gradient g_a1 (bf16) and
//    weight gradient (the tail of #6 and pass B);
//  - stage_input_bwd: from g_raw1 (bf16), conv1's dgrad and wgrad (the up
//    half per plane into the phase-separated g_up; the skip half once per
//    image on the image's summed g_raw1, g_img) and the transpose conv's
//    input, weight and bias gradients.
//
// Widths: a product's output channels (N) are one of the kernel's
// instances; a wider output runs in column groups (conv_cols, wgrad_cols),
// so every sequence takes any multiple of 16 input, up, skip and output
// channels. GroupNorm groups of other sizes lie zero-padded to whole
// chunks of 16 channels (decoder_common.cuh's GNIn::gk).
//
// The backward routes differ in where GroupNorm's statistics come from
// (the whole-plane route reduces them from the partial sums its recompute
// writes; the banded route reads those the forward saved) and in the
// GroupNorm backward between these sequences.
#pragma once

#include "decoder_bwd_common.cuh"
#include "decoder_igemm.cuh"

namespace {

using igemm::Epi;
using igemm::Planes;

#define SEMIVL_CK(call)        \
  do {                         \
    const int e_ = (call);     \
    if (e_ != 0) return e_;    \
  } while (0)

template <int TAPS>
int conv_n(int n, const Planes& in, const bf16* w, int nsplit, const Epi& e, cudaStream_t st,
           int wrows = 0) {
  switch (n) {
    case 16: return igemm::conv<16, TAPS>(in, w, nsplit, e, st, wrows);
    case 32: return igemm::conv<32, TAPS>(in, w, nsplit, e, st, wrows);
    case 48: return igemm::conv<48, TAPS>(in, w, nsplit, e, st, wrows);
    case 64: return igemm::conv<64, TAPS>(in, w, nsplit, e, st, wrows);
    case 96: return igemm::conv<96, TAPS>(in, w, nsplit, e, st, wrows);
  }
  if constexpr (TAPS == 1) {
    if (n == 128) return igemm::conv<128, 1>(in, w, nsplit, e, st, wrows);
  }
  return (int)cudaErrorInvalidValue;
}

// Weight gradient of a 3x3 conv (N = 16, 32 or 64 columns) or of the
// transpose conv (B = its input, N = 32, 64, 96 or 128), from B's channel
// n0 on.
constexpr int WGRAD9_N[] = {16, 32, 64};
constexpr int WGRAD1_N[] = {32, 64, 96, 128};

template <int TAPS>
int wgrad_n(int n, const Planes& in, const Planes& g, int planes, int mrows, int slots,
            float* part, cudaStream_t st, int n0 = 0) {
  if constexpr (TAPS == 9) {
    switch (n) {
      case 16: return igemm::wgrad<16, 9>(in, g, planes, mrows, slots, part, st, n0);
      case 32: return igemm::wgrad<32, 9>(in, g, planes, mrows, slots, part, st, n0);
      case 64: return igemm::wgrad<64, 9>(in, g, planes, mrows, slots, part, st, n0);
    }
  } else {
    switch (n) {
      case 32: return igemm::wgrad<32, 1>(in, g, planes, mrows, slots, part, st, n0);
      case 64: return igemm::wgrad<64, 1>(in, g, planes, mrows, slots, part, st, n0);
      case 96: return igemm::wgrad<96, 1>(in, g, planes, mrows, slots, part, st, n0);
      case 128: return igemm::wgrad<128, 1>(in, g, planes, mrows, slots, part, st, n0);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The widest of `widths` (ascending) that is at most `c`: the next column
// group of an output `c` channels wide (a multiple of 16) still to cover.
template <int K>
int widest_in(const int (&widths)[K], int c) {
  int n = 0;
  for (int k = 0; k < K; ++k)
    if (widths[k] <= c) n = widths[k];
  return n;
}

// The narrowest of `widths` (ascending) that is at least `c`, else the
// widest.
template <int K>
int wgrad_width(const int (&widths)[K], int c) {
  for (int k = 0; k < K; ++k)
    if (widths[k] >= c) return widths[k];
  return widths[K - 1];
}

constexpr int CONV9_N[] = {16, 32, 48, 64, 96};
constexpr int CONV1_N[] = {16, 32, 48, 64, 96, 128};

// The conv kernel over `in` with an output of c channels (a multiple of
// 16), in column groups of the widest instance that fits what is left:
// group n0 reads the weights' rows n0 .. (TAPS = 9: w [9][c][C]; TAPS = 1
// and nsplit 1: w [c][C]) and writes the output's channels n0 .. of `e`
// (EPI_BF16, EPI_F32 or EPI_PHASE over planes of c channels, H x W the
// conv's grid), with the addend's channels n0 .. and the GroupNorm
// partials of chunks n0 / 16 .. (EPI_BF16).
template <int TAPS>
int conv_cols(int c, const Planes& in, const bf16* w, Epi e, cudaStream_t st) {
  if (c % 16) return (int)cudaErrorInvalidValue;
  e.cstride = c;
  const size_t hw = (size_t)in.H * in.W;
  const size_t plane = e.mode == igemm::EPI_PHASE ? (size_t)(in.H / 2) * e.pitch : hw;
  const size_t elem = e.mode == igemm::EPI_F32 ? 4 : 2;
  const size_t tiles = (size_t)((in.H + igemm::CONV_ROWS - 1) / igemm::CONV_ROWS) *
                       ((in.W + igemm::TW - 1) / igemm::TW);
  for (int n0 = 0; n0 < c;) {
    const int n = TAPS == 9 ? widest_in(CONV9_N, c - n0) : widest_in(CONV1_N, c - n0);
    Epi g = e;
    g.out = static_cast<char*>(e.out) + n0 * plane * elem;
    if (e.add != nullptr) g.add = e.add + n0 * hw;
    if (e.gn_part != nullptr) g.gn_part = e.gn_part + n0 / 16 * tiles * 2;
    SEMIVL_CK(conv_n<TAPS>(n, in, w + (size_t)n0 * in.C, 1, g, st, c));
    n0 += n;
  }
  return 0;
}

// The wgrad kernel with B = g's c channels (the weight gradient's columns),
// in column groups: each the narrowest instance that covers what is left
// (or the widest), its partials summed in order into out's columns n0 ..
// (out [TAPS][mrows][c]); columns a group computes past c are dropped.
// part: slots TAPS mrows wgrad_width(c) floats.
template <int TAPS>
int wgrad_cols(int c, const Planes& in, const Planes& g, int planes, int mrows, int slots,
               float* part, float* out, cudaStream_t st) {
  for (int n0 = 0; n0 < c;) {
    const int n = TAPS == 9 ? wgrad_width(WGRAD9_N, c - n0) : wgrad_width(WGRAD1_N, c - n0);
    SEMIVL_CK(wgrad_n<TAPS>(n, in, g, planes, mrows, slots, part, st, n0));
    const int cols = c - n0 < n ? c - n0 : n;
    sum_partial_cols(part, slots, TAPS * mrows, n, cols, c, out + n0, st);
    n0 += cols;
  }
  return (int)cudaGetLastError();
}

// An epilogue writing `out` in `mode`; `promote`: the stage forward's
// products (stage_recompute) add each K step into their sums on the CUDA
// cores (decoder_igemm.cuh's conv_kernel), the backward's chain them.
Epi epi(int mode, void* out, bool promote = false) {
  Epi e{};
  e.mode = mode;
  e.out = out;
  e.add_rep = 1;
  e.promote = promote;
  return e;
}

// out[b][j] = bf16(sum_n g[b * N + n][j]) for j < per: the gradient of the
// per-image skip term, summed in float32 over the image's N class planes.
__global__ void plane_sum_bf16_kernel(const bf16* __restrict__ g, int N, size_t per, int B,
                                      bf16* __restrict__ out) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)B * per) return;
  const size_t b = i / per, j = i % per;
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += __bfloat162float(g[(b * N + n) * per + j]);
  out[i] = __float2bfloat16(s);
}

// part[p][c] = the sum of plane p's channel c, over `phases` phase planes
// [p][phase][C][h][pitch] (h x w pixels each): the transpose conv's bias
// gradient from g_up's 4 phases, the head's from g_out (1 phase, C = 1).
__global__ void __launch_bounds__(NT)
channel_total_kernel(const bf16* __restrict__ x, int C, int phases, int h, int w, int pitch,
                     float* __restrict__ part) {
  __shared__ float2 s_red[NT / 32];
  const int c = blockIdx.x, p = blockIdx.y;
  float s = 0.f;
  for (int k = 0; k < phases; ++k) {
    const bf16* q = x + (((size_t)p * phases + k) * C + c) * h * (size_t)pitch;
    for (int i = threadIdx.x; i < h * w; i += NT) s += __bfloat162float(q[(i / w) * pitch + i % w]);
  }
  const float2 r = block_sum2(s, 0.f, s_red);
  if (threadIdx.x == 0) part[(size_t)p * C + c] = r.x;
}

// A stage: P planes of cin channels on an h x w grid, its output 2h x 2w;
// B images (skips of cs channels); cu up channels, cout output channels.
struct Stage {
  int P, cin, h, w, B, cs, cu, cout;
};

// The stage forward from its inputs (xin, the stage input after any
// GroupNorm+ReLU; skip). Weights in the igemm layouts (bf16): up_wf, per
// column group of the up channels (the widest transpose-conv instance that
// fits what is left, widest_in(CONV1_N)), [4][group][cin] (phase ky * 2 +
// kx), one group after another; w1u [9][cout][cu], w1s [9][cout][cs], w2
// [9][cout][cout]; up_b float32 [cu]. Writes up (P, cu, H, W), raw1 and
// raw2 (P, cout, H, W) in bf16, with GroupNorm partials of each into part1
// / part2 when they are set ([P][cout / 16][tiles][2]); a1 = GN1+ReLU(raw1)
// by gn1; ys (B, cout, H, W) float32 is conv1's skip half, left out when
// `skip_half` is false (a planted fault). The column-shifted copies of a1
// stay in `scr` (3 P max(C) H tma_pitch(W) elements) as *a1_src.
int stage_recompute(const Stage& s, const bf16* xin, const bf16* skip, const bf16* up_wf,
                    const float* up_b, const bf16* w1u, const bf16* w1s, const bf16* w2,
                    bool skip_half, const GNIn& gn1, bf16* up, float* ys, bf16* c1,
                    float* part1, bf16* a1, bf16* c2, float* part2, bf16* scr, Planes* a1_src,
                    cudaStream_t st) {
  const int H = 2 * s.h, W = 2 * s.w, HW = H * W;
  const Planes xs = igemm::tma_source(xin, s.P, s.cin, s.h, s.w, scr, st);
  if (s.cu % 16) return (int)cudaErrorInvalidValue;
  for (int n0 = 0, n; n0 < s.cu; n0 += n) {
    n = widest_in(CONV1_N, s.cu - n0);
    Epi e = epi(igemm::EPI_TCONV, up + (size_t)n0 * HW, true);
    e.bias = up_b + n0;
    e.cstride = s.cu;
    SEMIVL_CK(conv_n<1>(n, xs, up_wf + (size_t)4 * n0 * s.cin, 4, e, st));
  }
  if (skip_half)
    SEMIVL_CK(conv_cols<9>(s.cout, igemm::shifted_source(skip, s.B, s.cs, H, W, scr, st), w1s,
                           epi(igemm::EPI_F32, ys, true), st));
  Epi e = epi(igemm::EPI_BF16, c1, true);
  e.add = skip_half ? ys : nullptr;
  e.add_rep = s.P / s.B;
  e.gn_part = part1;
  SEMIVL_CK(conv_cols<9>(s.cout, igemm::shifted_source(up, s.P, s.cu, H, W, scr, st), w1u, e,
                         st));
  gn_relu_kernel<<<dim3((HW + NT - 1) / NT, s.P), NT, 0, st>>>(c1, s.cout, HW, gn1, a1);
  *a1_src = igemm::shifted_source(a1, s.P, s.cout, H, W, scr, st);
  e = epi(igemm::EPI_BF16, c2, true);
  e.gn_part = part2;
  SEMIVL_CK(conv_cols<9>(s.cout, *a1_src, w2, e, st));
  return (int)cudaGetLastError();
}

// The head (cout -> 1 channel, 3x3) backward from the logits' gradient
// g_out (bf16 (P, 1, H, W)) and the stage's raw conv2 c2 with gn2: g_a2 =
// dgrad(g_out) (bf16, on the CUDA cores: K = 9; head_wd float32 [1][9]
// [cout], flipped), its weight gradient g_hw [9][cout][16] (column 0; the
// wgrad kernel at N = 16 over a2 = GN2+ReLU(c2), `slots` partials in
// igpart) and its bias gradient g_hb [1] (per-plane totals in bpart [P]).
// Scratch: a2 bf16 (P, cout, H, W); scr_b as stage_recompute's scr;
// scr_g bf16 P H tma_pitch(W).
int head_bwd(const Stage& s, const bf16* c2, const GNIn& gn2, const bf16* g_out,
             const float* head_wd, bf16* a2, bf16* g_a2, float* igpart, int slots, float* g_hw,
             float* bpart, float* g_hb, bf16* scr_b, bf16* scr_g, cudaStream_t st) {
  const int H = 2 * s.h, W = 2 * s.w, HW = H * W;
  gn_relu_kernel<<<dim3((HW + NT - 1) / NT, s.P), NT, 0, st>>>(c2, s.cout, HW, gn2, a2);
  SEMIVL_CK(conv(s.cout, g_out, s.P, 1, H, W, NO_GN, head_wd, nullptr, g_a2, st));
  SEMIVL_CK(wgrad_n<9>(16, igemm::shifted_source(a2, s.P, s.cout, H, W, scr_b, st),
                       igemm::tma_source(g_out, s.P, 1, H, W, scr_g, st), s.P, s.cout, slots,
                       igpart, st));
  sum_partials(igpart, slots, 9 * s.cout * 16, g_hw, st);
  channel_total_kernel<<<dim3(1, s.P), NT, 0, st>>>(g_out, 1, 1, H, W, W, bpart);
  sum_partials(bpart, s.P, 1, g_hb, st);
  return (int)cudaGetLastError();
}

// conv2's backward from g_raw2 (bf16 (P, cout, H, W)): g_a1 = its dgrad
// (bf16; w2_d [9][cout][cout], flipped and transposed) and g_w2 [9][cout]
// [cout] = its wgrad over a1 (a1_src: stage_recompute's column-shifted
// copies of GN1+ReLU(raw1)) and g_raw2, reduced over the first
// `wg_planes` planes (P; fewer only for a planted fault) in `slots`
// partials (igpart: slots 9 cout wgrad_width(cout) floats) added in order.
// scr: room
// for g_raw2's three shifted copies (3 P cout H tma_pitch(W)).
int conv2_bwd(const Stage& s, const bf16* g_raw2, const Planes& a1_src, const bf16* w2_d,
              int wg_planes, int slots, float* igpart, bf16* g_a1, float* g_w2, bf16* scr,
              cudaStream_t st) {
  const Planes gr2 = igemm::shifted_source(g_raw2, s.P, s.cout, 2 * s.h, 2 * s.w, scr, st);
  SEMIVL_CK(conv_cols<9>(s.cout, gr2, w2_d, epi(igemm::EPI_BF16, g_a1), st));
  return wgrad_cols<9>(s.cout, a1_src, igemm::center(gr2), wg_planes, s.cout, slots, igpart,
                       g_w2, st);
}

// The input half of a stage's backward from g_c1 = g_raw1 (bf16 (P, cout,
// H, W)): conv1's up half (dgrad into the phase-separated g_up gph, bf16
// [P][4][cu][h][pitch]; wgrad over all planes -> g_w1u [9][cu][cout]), its
// skip half on the per-image sum of g_raw1 (g_img, bf16 (B, cout, H, W);
// dgrad -> g_skip float32 (B, cs, H, W), wgrad over the first `skip_planes`
// images (B; fewer only for a planted fault) -> g_w1s [9][cs][cout]) and
// the transpose conv (g_xin (P, cin, h, w) bf16, g_up_w [4 cu][cin], g_up_b
// [cu]). up and xin are the recompute's; w1u_d [9][cu][cout], w1s_d [9][cs]
// [cout] and up_wd [cin][4 cu] the dgrad weights (bf16). slots[3]: each
// wgrad's partials in igpart (room for the largest: slots 9 cu
// wgrad_width(cout), slots 9 cs wgrad_width(cout), slots 4 cu
// wgrad_width(cin) floats). Scratch: bpart (P, cu); scr_a, scr_b as
// stage_recompute's scr.
int stage_input_bwd(const Stage& s, const bf16* g_c1, const bf16* up, const bf16* xin,
                    const bf16* skip, const bf16* up_wd, const bf16* w1u_d, const bf16* w1s_d,
                    int pitch, const int* slots, int skip_planes, bf16* gph, bf16* g_img,
                    float* igpart, float* bpart, bf16* scr_a, bf16* scr_b, bf16* g_xin,
                    float* g_skip, float* g_w1u, float* g_w1s, float* g_up_w, float* g_up_b,
                    cudaStream_t st) {
  const int H = 2 * s.h, W = 2 * s.w;
  // conv1, up half: g_up (into its phases) and the weight gradient
  const Planes g1 = igemm::shifted_source(g_c1, s.P, s.cout, H, W, scr_a, st);
  Epi e = epi(igemm::EPI_PHASE, gph);
  e.pitch = pitch;
  SEMIVL_CK(conv_cols<9>(s.cu, g1, w1u_d, e, st));
  SEMIVL_CK(wgrad_cols<9>(s.cout, igemm::shifted_source(up, s.P, s.cu, H, W, scr_b, st),
                          igemm::center(g1), s.P, s.cu, slots[0], igpart, g_w1u, st));
  // conv1, skip half: once per image on the image's summed g_raw1
  const size_t per = (size_t)s.cout * H * W;
  plane_sum_bf16_kernel<<<(unsigned)((s.B * per + NT - 1) / NT), NT, 0, st>>>(
      g_c1, s.P / s.B, per, s.B, g_img);
  const Planes gi = igemm::shifted_source(g_img, s.B, s.cout, H, W, scr_a, st);
  SEMIVL_CK(conv_cols<9>(s.cs, gi, w1s_d, epi(igemm::EPI_F32, g_skip), st));
  SEMIVL_CK(wgrad_cols<9>(s.cout, igemm::shifted_source(skip, s.B, s.cs, H, W, scr_b, st),
                          igemm::center(gi), skip_planes, s.cs, slots[1], igpart, g_w1s, st));
  // the transpose conv: g_x (K = 4 cu), the weight gradient (K = input
  // pixels) and the bias gradient
  const Planes gp{gph, s.P, 4 * s.cu, s.h, s.w, pitch, false};
  SEMIVL_CK(conv_cols<1>(s.cin, gp, up_wd, epi(igemm::EPI_BF16, g_xin), st));
  SEMIVL_CK(wgrad_cols<1>(s.cin, gp, igemm::tma_source(xin, s.P, s.cin, s.h, s.w, scr_b, st),
                          s.P, 4 * s.cu, slots[2], igpart, g_up_w, st));
  channel_total_kernel<<<dim3(s.cu, s.P), NT, 0, st>>>(gph, s.cu, 4, s.h, s.w, pitch, bpart);
  sum_partials(bpart, s.P, s.cu, g_up_b, st);
  return (int)cudaGetLastError();
}

}  // namespace
