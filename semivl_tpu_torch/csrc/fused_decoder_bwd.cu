// Fused VLG decoder Up stage backward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels behind the backward of
// semivl_tpu/ops/fused_decoder.py::fused_vlg_decoder (_stage_bwd):
//   decoder_stage_bwd_tail  <- _stage_bwd_tail_kernel: recompute the stage
//     forward from its inputs, then the head backward (last stage), the
//     GN2+ReLU backward, conv2 dgrad and wgrad, and the GN1+ReLU backward
//     down to g_raw1, the gradient of the raw conv1 output, with the
//     GroupNorm scale and shift gradients;
//   decoder_stage_bwd_input <- _stage_bwd_input_kernel: from g_raw1, the
//     conv1 dgrad and wgrad of both halves (the up half per plane, the skip
//     half once per image over the image's summed planes) and the 2x2
//     stride-2 transpose conv backward (input, weight and bias gradients).
// A stage whose input is the previous stage's raw conv2 (GN2+ReLU applied
// on load in the forward) returns the gradient of that normalised input;
// its GN2+ReLU backward is the previous stage's tail.
//
// What bounds it on this card: about twice the forward's convolution work
// (dgrad and wgrad of every conv), ~440 GFLOP at the flagship training
// shape (P = 126 planes), so it is bound by operations. Like the forward
// it runs on the CUDA cores in float32: dgrads are the forward's direct
// 3x3 convolution with flipped, transposed weights; wgrads are register-
// tiled reductions over (plane, 8x8 tile) items, each block summing its
// share of the items and a second pass adding the blocks' partials in a
// fixed order (no float atomics: two runs agree bit for bit). Tensor-core
// implicit GEMM is later work.
//
// Design against the TPU kernels. They kept a plane in VMEM, recomputed the
// forward there and accumulated weight gradients across a sequential grid.
// Here blocks run in parallel, so the stage is a sequence of kernels on the
// stream: the forward's tile kernels recompute up, conv1, conv2 and their
// GroupNorm partial sums into device memory (nothing is saved from the
// forward but the stage inputs), elementwise kernels apply the GroupNorm
// backward, whose whole-plane sums of g and g * x_hat come from per-block
// partials reduced in the consumer's prologue, and gradients between the
// steps are kept in float32.

#include "decoder_bwd_common.cuh"

namespace {

// Tensor slots of decoder_stage_bwd_tail (t[]) and its sizes (d[]).
enum TailSlot {
  T_X, T_GN_PART, T_GN_GAMMA, T_GN_BETA, T_SKIP, T_UP_W, T_UP_B, T_W1U, T_W1S, T_W2,
  T_G1W, T_G1B, T_G2W, T_G2B, T_W2_D, T_HEAD_WD, T_G_OUT, T_G_A2,
  T_XIN, T_UP, T_YS, T_C1, T_PART1, T_C2, T_PART2, T_A1, T_A2, T_GY, T_GC, T_GPART,
  T_WPART, T_BPART,
  T_G_C1, T_G_W2, T_G_G1W, T_G_G1B, T_G_G2W, T_G_G2B, T_G_HW, T_G_HB, T_COUNT
};
enum InputSlot {
  I_G_C1, I_UP, I_XIN, I_SKIP, I_UP_W, I_W1U_D, I_W1S_D, I_G_UP, I_G_IMG, I_WPART, I_BPART,
  I_G_XIN, I_G_SKIP, I_G_W1U, I_G_W1S, I_G_UP_W, I_G_UP_B, I_COUNT
};
enum Dim { D_P, D_CIN, D_H, D_W, D_GN_NPARTS, D_B, D_CS, D_CU, D_COUT, D_R, D_COUNT };

}  // namespace

// The tail of one stage's backward. The stage is the forward's
// decoder_stage_fwd with the same inputs (x, optional GN on load, skip and
// weights in the same layouts); the gradient comes in as g_out (the head
// logits' gradient, bf16 (P, 1, H, W), when T_HEAD_WD holds the head's
// dgrad weights [1][9][cout]) or as T_G_A2 (float32 (P, cout, H, W), the
// gradient of GN2+ReLU(conv2)). T_W2_D holds conv2's dgrad weights
// [cout][9][cout] (w2 flipped and transposed). Outputs: T_G_C1 (float32
// gradient of the raw conv1 output), the weight gradients g_w2 [cout][9]
// [cout] and g_hw [cout][9][1], g_hb [1], and the GroupNorm scale/shift
// gradients [cout]. T_XIN (GN+ReLU of x when T_GN_PART is set, else x
// itself) and T_UP (the recomputed transpose conv output) are left for
// decoder_stage_bwd_input. Scratch sizes: T_A1, T_A2 (P, cout, H, W) bf16,
// T_GY, T_GC (P, cout, H, W) float32, T_GPART (P, cout, ceil(H W / 256),
// 2), T_WPART (R, cout * 9 * cout), T_BPART (R, 1); the forward's scratch
// as decoder_stage_fwd. Returns cudaGetLastError() after the launches.
extern "C" int decoder_stage_bwd_tail(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT], R = d[D_R];
  const int H = 2 * h, W = 2 * w, HW = H * W;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const float inv_in = 1.f / (GSIZE * (float)h * (float)w);
  const float inv_out = 1.f / (GSIZE * (float)H * (float)W);
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };

  if (t[T_GN_PART] != nullptr) {
    GNIn gx{f(T_GN_PART), f(T_GN_GAMMA), f(T_GN_BETA), d[D_GN_NPARTS], inv_in};
    gn_relu_kernel<<<dim3((h * w + NT - 1) / NT, P), NT, 0, st>>>(b16(T_X), cin, h * w, gx,
                                                                   b16(T_XIN));
  }
  // 1. recompute the stage forward from its inputs
  tconv2x2_kernel<<<dim3(tiles, P, cu / CU_T), NT, 0, st>>>(b16(T_XIN), cin, h, w, NO_GN,
                                                            f(T_UP_W), f(T_UP_B), cu, b16(T_UP));
  conv(cout, (const bf16*)b16(T_SKIP), B, cs, H, W, NO_GN, f(T_W1S), nullptr, nullptr, 1,
       nullptr, f(T_YS), nullptr, st);
  conv(cout, (const bf16*)b16(T_UP), P, cu, H, W, NO_GN, f(T_W1U), nullptr, f(T_YS), P / B,
       b16(T_C1), nullptr, f(T_PART1), st);
  const GNIn gn1{f(T_PART1), f(T_G1W), f(T_G1B), tiles, inv_out};
  conv(cout, (const bf16*)b16(T_C1), P, cout, H, W, gn1, f(T_W2), nullptr, nullptr, 1,
       b16(T_C2), nullptr, f(T_PART2), st);
  const GNIn gn2{f(T_PART2), f(T_G2W), f(T_G2B), tiles, inv_out};
  const int eb = (HW + NT - 1) / NT;

  // 2. the head: g_a2 = dgrad(g_out), head weight and bias gradients
  if (t[T_HEAD_WD] != nullptr) {
    gn_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(T_C2), cout, HW, gn2, b16(T_A2));
    conv(cout, (const bf16*)b16(T_G_OUT), P, 1, H, W, NO_GN, f(T_HEAD_WD), nullptr, nullptr, 1,
         nullptr, f(T_G_A2), nullptr, st);
    wgrad(1, (const bf16*)b16(T_G_OUT), b16(T_A2), P, cout, H, W, R, f(T_WPART), f(T_BPART),
          f(T_G_HW), f(T_G_HB), st);
  }
  // 3. GN2+ReLU backward -> g_c2 (T_GC)
  gn_backward(f(T_G_A2), b16(T_C2), P, cout, HW, gn2, f(T_GY), f(T_GPART), f(T_GC),
              f(T_G_G2W), f(T_G_G2B), st);
  // 4. conv2: g_a1 = dgrad(g_c2) (into T_GY), g_w2 = wgrad(g_c2, a1)
  gn_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(T_C1), cout, HW, gn1, b16(T_A1));
  conv(cout, (const float*)f(T_GC), P, cout, H, W, NO_GN, f(T_W2_D), nullptr, nullptr, 1,
       nullptr, f(T_GY), nullptr, st);
  wgrad(cout, (const float*)f(T_GC), b16(T_A1), P, cout, H, W, R, f(T_WPART), f(T_BPART),
        f(T_G_W2), nullptr, st);
  // 5. GN1+ReLU backward -> g_raw1
  gn_backward(f(T_GY), b16(T_C1), P, cout, HW, gn1, f(T_GY), f(T_GPART), f(T_G_C1),
              f(T_G_G1W), f(T_G_G1B), st);
  return (int)cudaGetLastError();
}

// The input half of one stage's backward, from g_raw1 (I_G_C1, float32
// (P, cout, H, W)): conv1's up half (dgrad -> I_G_UP, wgrad over all
// planes -> I_G_W1U [cu][9][cout]), its skip half on the per-image sum of
// g_raw1 (I_G_IMG; dgrad -> I_G_SKIP (B, cs, H, W), wgrad -> I_G_W1S
// [cs][9][cout]) and the transpose conv (I_G_XIN (P, cin, h, w) float32,
// I_G_UP_W [cin][4][cu], I_G_UP_B [cu]). I_UP and I_XIN are the tail's
// recomputed tensors; I_W1U_D [cout][9][cu] and I_W1S_D [cout][9][cs] are
// conv1's dgrad weights. Scratch: I_WPART (R, max weight size), I_BPART
// (R, cu). Returns cudaGetLastError() after the launches.
extern "C" int decoder_stage_bwd_input(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT], R = d[D_R];
  const int H = 2 * h, W = 2 * w;
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };

  conv(cu, (const float*)f(I_G_C1), P, cout, H, W, NO_GN, f(I_W1U_D), nullptr, nullptr, 1,
       nullptr, f(I_G_UP), nullptr, st);
  wgrad(cout, (const float*)f(I_G_C1), b16(I_UP), P, cu, H, W, R, f(I_WPART), f(I_BPART),
        f(I_G_W1U), nullptr, st);
  const size_t per = (size_t)cout * H * W;
  plane_sum_kernel<<<(unsigned)((B * per + NT - 1) / NT), NT, 0, st>>>(f(I_G_C1), P / B, per, B,
                                                                        f(I_G_IMG));
  conv(cs, (const float*)f(I_G_IMG), B, cout, H, W, NO_GN, f(I_W1S_D), nullptr, nullptr, 1,
       nullptr, f(I_G_SKIP), nullptr, st);
  wgrad(cout, (const float*)f(I_G_IMG), b16(I_SKIP), B, cs, H, W, R, f(I_WPART), f(I_BPART),
        f(I_G_W1S), nullptr, st);
  const int tiles_in = ((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE);
  tconv_dgrad_kernel<<<dim3(tiles_in, P, cin / CIT), NT, 0, st>>>(f(I_G_UP), cu, h, w,
                                                                  f(I_UP_W), cin, f(I_G_XIN));
  tconv_wgrad(cu, b16(I_XIN), f(I_G_UP), P, cin, h, w, R, f(I_WPART), f(I_BPART), f(I_G_UP_W),
              f(I_G_UP_B), st);
  return (int)cudaGetLastError();
}
