// Banded VLG decoder stage backward for Hopper (sm_90a): three passes that
// take the forward's saved GroupNorm statistics.
//
// Replaces the three Pallas TPU kernels of
// semivl_tpu/ops/fused_decoder_banded.py::_stage_bwd_banded:
//   banded_pass_a <- _pass_a_kernel: recompute the stage's transpose conv
//     (up) and raw conv1 / conv2 outputs (raw1, raw2) from the stage inputs,
//     normalising with the SAVED statistics; on the last stage the head's
//     weight, bias and input gradients; gy2, the ReLU-masked gradient in
//     front of GN2; and the per-plane GN2 reduction sums of gy2 and
//     gy2 * x_hat2;
//   banded_pass_b <- _pass_b_kernel: the GN2 solve (graw2 from gy2 and the
//     closed reduction vectors), conv2's weight gradient and input gradient
//     g_a1, gy1 and the per-plane GN1 reduction sums;
//   banded_pass_c <- _pass_c_kernel: the GN1 solve (graw1), conv1's weight
//     gradients (up half per plane, skip half over each image's summed
//     planes), the input gradients of up and the skip, and the transpose
//     conv backward (input, weight and bias gradients).
// Between the passes the caller closes the reductions on (P, C) vectors in
// plain PyTorch: the GroupNorm scale/shift gradients and the per-plane mean
// gradient vectors mga = sum_group(gamma * sgy) / n and mgb = sum_group(
// gamma * sgy * x_hat) / n, so graw = rstd (gamma gy - mga - x_hat mgb).
//
// What bounds it on this card: like the whole-plane backward, about twice
// the forward's convolution work plus one recompute; at the Cityscapes
// training shape (P = 57 planes, base grid 51x51) tens of GFLOP on the CUDA
// cores in float32, so bound by operations. Tensor-core implicit GEMM is
// later work.
//
// Design against the TPU kernels. They cut each plane into overlapping row
// bands with lane-aligned halos so a band fits VMEM, masked band interiors
// so each row counted once, and carried the reductions and weight
// gradients across a sequential grid. Here each pass is a short sequence of
// tile kernels over (16x16 output tile, plane) blocks, each output pixel
// owned by one block: no band copies or halo masks, and sums count each
// pixel once by construction. Weight gradients are per-block partials added
// in a fixed order (no float atomics, so two runs agree bit for bit); the
// per-plane reduction sums are per-block partials added in order in double.
// The spilled tensors (xin, up, raw1, raw2 in bf16; gy2, gy1 in float32)
// live in device memory; gradients between the steps are float32. Unlike
// the whole-plane kernels (fused_decoder_bwd.cu), no whole-plane statistic
// is recomputed: GroupNorm normalises with the statistics the forward
// saved (decoder_gn_stats), bit-identical to those it normalised with.

#include "decoder_bwd_common.cuh"

namespace {

// g_c = rstd (gamma g_y - mga - x_hat mgb) over (P, C, HW) planes, with
// x_hat from the raw input c and the saved statistics; mga, mgb [P][C].
__global__ void __launch_bounds__(NT)
gn_solve_kernel(const float* __restrict__ g_y, const bf16* __restrict__ c, int C, int HW,
                GNIn gn, const float* __restrict__ mga, const float* __restrict__ mgb,
                float* __restrict__ g_c) {
  __shared__ float s_mean[MAXG], s_rstd[MAXG];
  const int p = blockIdx.y;
  gn_prologue(gn, p, C / GSIZE, s_mean, s_rstd);
  const int pix = blockIdx.x * NT + threadIdx.x;
  if (pix >= HW) return;
  for (int ch = 0; ch < C; ++ch) {
    const size_t i = ((size_t)p * C + ch) * HW + pix;
    const int g = ch / GSIZE;
    const float xh = (__bfloat162float(c[i]) - s_mean[g]) * s_rstd[g];
    const size_t v = (size_t)p * C + ch;
    g_c[i] = s_rstd[g] * (gn.gamma[ch] * g_y[i] - mga[v] - xh * mgb[v]);
  }
}

// sums[i][2] = the nslots (sum g_y, sum g_y x_hat) partials of row i =
// (plane, channel), added in order in double.
__global__ void plane_sums_kernel(const float* __restrict__ gpart, int n, int nslots,
                                  float* __restrict__ sums) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* q = gpart + (size_t)i * nslots * 2;
  double a = 0.0, b = 0.0;
  for (int s = 0; s < nslots; ++s) {
    a += q[2 * s];
    b += q[2 * s + 1];
  }
  sums[2 * (size_t)i] = (float)a;
  sums[2 * (size_t)i + 1] = (float)b;
}

GNIn saved(const void* gamma, const void* beta, const void* mean, const void* rstd) {
  return GNIn{nullptr, (const float*)gamma, (const float*)beta, 0, 0.f, (const float*)mean,
              (const float*)rstd};
}

// gy = g_a masked by the ReLU of GN(c) and its per-plane reduction sums
// [P][C][2] (gpart: P * C * ceil(HW / NT) * 2 floats of scratch).
void relu_mask_and_sums(const float* g_a, const bf16* c, int P, int C, int HW, const GNIn& gn,
                        float* gy, float* gpart, float* sums, cudaStream_t st) {
  const int eb = (HW + NT - 1) / NT;
  gn_bwd_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(g_a, c, C, HW, gn, gy, gpart);
  plane_sums_kernel<<<(P * C + NT - 1) / NT, NT, 0, st>>>(gpart, P * C, eb, sums);
}

enum Dim { D_P, D_CIN, D_H, D_W, D_B, D_CS, D_CU, D_COUT, D_R, D_COUNT };

enum ASlot {
  A_X, A_GX_MEAN, A_GX_RSTD, A_GX_GAMMA, A_GX_BETA, A_SKIP, A_UP_W, A_UP_B, A_W1U, A_W1S, A_W2,
  A_G1W, A_G1B, A_G2W, A_G2B, A_M1, A_R1, A_M2, A_R2, A_HEAD_WD, A_G_OUT, A_G_A2,
  A_XIN, A_UP, A_YS, A_RAW1, A_RAW2, A_A2, A_GY2, A_GPART, A_SUMS, A_WPART, A_BPART,
  A_G_HW, A_G_HB, A_COUNT
};
enum BSlot {
  B_RAW1, B_RAW2, B_GY2, B_M1, B_R1, B_M2, B_R2, B_G1W, B_G1B, B_G2W, B_G2B, B_MGA, B_MGB,
  B_W2_D, B_GRAW2, B_A1, B_GY1, B_GPART, B_SUMS, B_WPART, B_BPART, B_G_W2, B_COUNT
};
enum CSlot {
  C_XIN, C_UP, C_SKIP, C_RAW1, C_GY1, C_M1, C_R1, C_G1W, C_G1B, C_MGA, C_MGB, C_UP_W,
  C_W1U_D, C_W1S_D, C_GRAW1, C_G_UP, C_G_IMG, C_WPART, C_BPART, C_G_XIN, C_G_SKIP, C_G_W1U,
  C_G_W1S, C_G_UP_W, C_G_UP_B, C_COUNT
};

}  // namespace

// Pass A of one stage. Inputs: x (P, cin, h, w) bf16, raw when A_GX_MEAN is
// set (then GN+ReLU with the saved A_GX_* statistics and affine gives xin,
// written to A_XIN; otherwise A_XIN is x itself); skip (B, cs, H, W) bf16;
// the weights in decoder_stage_fwd's layouts (float32, [ci][4][cu] and
// [ci][9][co]); the stage's saved statistics m1, r1, m2, r2 (P, cout); the
// gradient: with A_HEAD_WD (the head's dgrad weights [1][9][cout]) the
// logits' gradient A_G_OUT (P, 1, H, W) bf16, else A_G_A2 (P, cout, H, W)
// float32, the gradient of GN2+ReLU(raw2). Outputs: A_UP (P, cu, H, W),
// A_RAW1, A_RAW2 (P, cout, H, W) bf16; A_GY2 (P, cout, H, W) float32;
// A_SUMS (P, cout, 2) float32; with the head A_G_HW [cout][9][1] and A_G_HB
// [1] (and A_G_A2 is written). Scratch: A_YS (B, cout, H, W) float32, A_A2
// (P, cout, H, W) bf16 (head), A_GPART (P, cout, ceil(H W / 256), 2),
// A_WPART (R, cout * 9), A_BPART (R, 1). Returns cudaGetLastError() after
// the launches.
extern "C" int banded_pass_a(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT], R = d[D_R];
  const int H = 2 * h, W = 2 * w, HW = H * W;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const GNIn gn1 = saved(t[A_G1W], t[A_G1B], t[A_M1], t[A_R1]);
  const GNIn gn2 = saved(t[A_G2W], t[A_G2B], t[A_M2], t[A_R2]);

  if (t[A_GX_MEAN] != nullptr) {
    const GNIn gx = saved(t[A_GX_GAMMA], t[A_GX_BETA], t[A_GX_MEAN], t[A_GX_RSTD]);
    gn_relu_kernel<<<dim3((h * w + NT - 1) / NT, P), NT, 0, st>>>(b16(A_X), cin, h * w, gx,
                                                                   b16(A_XIN));
  }
  // recompute up, raw1 and raw2 (no partial sums: the statistics are saved)
  tconv2x2_kernel<<<dim3(tiles, P, cu / CU_T), NT, 0, st>>>(b16(A_XIN), cin, h, w, NO_GN,
                                                            f(A_UP_W), f(A_UP_B), cu, b16(A_UP));
  conv(cout, (const bf16*)b16(A_SKIP), B, cs, H, W, NO_GN, f(A_W1S), nullptr, nullptr, 1,
       nullptr, f(A_YS), nullptr, st);
  conv(cout, (const bf16*)b16(A_UP), P, cu, H, W, NO_GN, f(A_W1U), nullptr, f(A_YS), P / B,
       b16(A_RAW1), nullptr, nullptr, st);
  conv(cout, (const bf16*)b16(A_RAW1), P, cout, H, W, gn1, f(A_W2), nullptr, nullptr, 1,
       b16(A_RAW2), nullptr, nullptr, st);
  if (t[A_HEAD_WD] != nullptr) {
    const int eb = (HW + NT - 1) / NT;
    gn_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(A_RAW2), cout, HW, gn2, b16(A_A2));
    conv(cout, (const bf16*)b16(A_G_OUT), P, 1, H, W, NO_GN, f(A_HEAD_WD), nullptr, nullptr, 1,
         nullptr, f(A_G_A2), nullptr, st);
    wgrad(1, (const bf16*)b16(A_G_OUT), b16(A_A2), P, cout, H, W, R, f(A_WPART), f(A_BPART),
          f(A_G_HW), f(A_G_HB), st);
  }
  relu_mask_and_sums(f(A_G_A2), b16(A_RAW2), P, cout, HW, gn2, f(A_GY2), f(A_GPART),
                     f(A_SUMS), st);
  return (int)cudaGetLastError();
}

// Pass B of one stage. Inputs: raw1, raw2 (P, cout, H, W) bf16 and gy2
// float32 from pass A; the saved statistics; gamma/beta of both GroupNorms;
// the closed GN2 vectors B_MGA, B_MGB (P, cout); conv2's dgrad weights
// B_W2_D [cout][9][cout] (flipped, transposed). Outputs: B_GY1 (P, cout, H,
// W) float32, B_SUMS (P, cout, 2), B_G_W2 [cout][9][cout]. Scratch: B_GRAW2
// (P, cout, H, W) float32, B_A1 bf16, B_GPART, B_WPART (R, cout * 9 *
// cout). d[D_H], d[D_W] are the stage's INPUT grid (the planes are twice
// that). Returns cudaGetLastError() after the launches.
extern "C" int banded_pass_b(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cout = d[D_COUT], R = d[D_R];
  const int H = 2 * d[D_H], W = 2 * d[D_W], HW = H * W, eb = (HW + NT - 1) / NT;
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const GNIn gn1 = saved(t[B_G1W], t[B_G1B], t[B_M1], t[B_R1]);
  const GNIn gn2 = saved(t[B_G2W], t[B_G2B], t[B_M2], t[B_R2]);

  gn_solve_kernel<<<dim3(eb, P), NT, 0, st>>>(f(B_GY2), b16(B_RAW2), cout, HW, gn2, f(B_MGA),
                                               f(B_MGB), f(B_GRAW2));
  gn_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(B_RAW1), cout, HW, gn1, b16(B_A1));
  wgrad(cout, (const float*)f(B_GRAW2), b16(B_A1), P, cout, H, W, R, f(B_WPART), f(B_BPART),
        f(B_G_W2), nullptr, st);
  conv(cout, (const float*)f(B_GRAW2), P, cout, H, W, NO_GN, f(B_W2_D), nullptr, nullptr, 1,
       nullptr, f(B_GY1), nullptr, st);                                  // g_a1
  relu_mask_and_sums(f(B_GY1), b16(B_RAW1), P, cout, HW, gn1, f(B_GY1), f(B_GPART),
                     f(B_SUMS), st);
  return (int)cudaGetLastError();
}

// Pass C of one stage. Inputs: xin (P, cin, h, w) and up (P, cu, H, W) bf16
// from pass A, the skip, raw1 and gy1; the saved GN1 statistics and gamma;
// the closed GN1 vectors C_MGA, C_MGB; the transpose conv weights C_UP_W
// [cin][4][cu] and conv1's dgrad weights C_W1U_D [cout][9][cu], C_W1S_D
// [cout][9][cs]. Outputs (float32): C_G_XIN (P, cin, h, w), C_G_SKIP (B,
// cs, H, W), C_G_W1U [cu][9][cout], C_G_W1S [cs][9][cout], C_G_UP_W
// [cin][4][cu], C_G_UP_B [cu]. Scratch: C_GRAW1 (P, cout, H, W), C_G_UP (P,
// cu, H, W), C_G_IMG (B, cout, H, W), C_WPART (R, largest weight), C_BPART
// (R, cu). Returns cudaGetLastError() after the launches.
extern "C" int banded_pass_c(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT], R = d[D_R];
  const int H = 2 * h, W = 2 * w, HW = H * W, eb = (HW + NT - 1) / NT;
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const GNIn gn1 = saved(t[C_G1W], t[C_G1B], t[C_M1], t[C_R1]);

  gn_solve_kernel<<<dim3(eb, P), NT, 0, st>>>(f(C_GY1), b16(C_RAW1), cout, HW, gn1, f(C_MGA),
                                               f(C_MGB), f(C_GRAW1));
  conv(cu, (const float*)f(C_GRAW1), P, cout, H, W, NO_GN, f(C_W1U_D), nullptr, nullptr, 1,
       nullptr, f(C_G_UP), nullptr, st);
  wgrad(cout, (const float*)f(C_GRAW1), b16(C_UP), P, cu, H, W, R, f(C_WPART), f(C_BPART),
        f(C_G_W1U), nullptr, st);
  const size_t per = (size_t)cout * HW;
  plane_sum_kernel<<<(unsigned)((B * per + NT - 1) / NT), NT, 0, st>>>(f(C_GRAW1), P / B, per,
                                                                        B, f(C_G_IMG));
  conv(cs, (const float*)f(C_G_IMG), B, cout, H, W, NO_GN, f(C_W1S_D), nullptr, nullptr, 1,
       nullptr, f(C_G_SKIP), nullptr, st);
  wgrad(cout, (const float*)f(C_G_IMG), b16(C_SKIP), B, cs, H, W, R, f(C_WPART), f(C_BPART),
        f(C_G_W1S), nullptr, st);
  const int tiles_in = ((h + TILE - 1) / TILE) * ((w + TILE - 1) / TILE);
  tconv_dgrad_kernel<<<dim3(tiles_in, P, cin / CIT), NT, 0, st>>>(f(C_G_UP), cu, h, w,
                                                                  f(C_UP_W), cin, f(C_G_XIN));
  tconv_wgrad(cu, b16(C_XIN), f(C_G_UP), P, cin, h, w, R, f(C_WPART), f(C_BPART), f(C_G_UP_W),
              f(C_G_UP_B), st);
  return (int)cudaGetLastError();
}
