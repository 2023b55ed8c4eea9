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
// What bounds it on this card: about twice the forward's convolution work
// plus one recompute (tens of GFLOP at the Cityscapes training shape, P =
// 57 planes on a 51x51 base grid), so the tensor cores. The three passes
// run every product of more than one channel on decoder_igemm.cuh's wgmma
// implicit GEMM (bf16 operands, float32 sums, TMA rings), through the
// sequences they share with the whole-plane route (decoder_stage_bwd.cuh):
// pass A is stage_recompute (the transpose conv per output phase, conv1's
// skip half per image as the float32 addend of its up half, conv2 over
// GN1+ReLU of raw1; no GroupNorm partials, the statistics are saved) and,
// on the last stage, head_bwd (the head's dgrad on the CUDA cores, K = 9;
// its wgrad at N = 16); pass C is stage_input_bwd from graw1 (conv1's
// dgrad and wgrad, the skip half on the per-image sum g_img, the transpose
// conv's dgrad with K = 4 cu and its weight and bias gradients); pass B is
// conv2_bwd after a GN2 solve (conv2's dgrad on the column-shifted graw2,
// its wgrad over the shifted GN1+ReLU(raw1) with per-slot partials), the
// tail of the whole-plane route's kernel #6.
//
// The elementwise passes stay apart from the igemm epilogues: the GN solve
// (graw from gy), the ReLU mask with the per-plane sums, and GN1+ReLU of
// raw1 before conv2. The products read their operands straight from TMA
// into swizzled tiles, so a transform on load would cost a shared-memory
// pass in every K step; the separate passes read and write each plane
// once, and they are where the pass's own reductions (the GN sums in
// double) happen.
//
// Storage, as JAX's banded kernels store (cdt = bf16): gy2, graw2 (pass B's
// scratch), gy1, graw1 (pass C's scratch) and the stage input's gradient
// g_x are bf16, as are the head's dgrad output g_a2 and conv2's g_a1 that
// the ReLU masks turn into gy2 and gy1 (the masks keep bf16 values bf16),
// and two operands that JAX never forms (the transpose conv output's
// gradient g_up, phase-separated, and the per-image sum g_img), as the
// whole-plane route stores them. The GN sums are taken over the stored
// values. g_skip and every weight, bias and GroupNorm gradient are
// float32.
//
// Design against the TPU kernels. They cut each plane into overlapping row
// bands with lane-aligned halos so a band fits VMEM, masked band interiors
// so each row counted once, and carried the reductions and weight
// gradients across a sequential grid. Here each pass is a short sequence of
// kernels over whole planes, each output pixel owned by one block: no band
// copies or halo masks, and sums count each pixel once by construction.
// Weight gradients are per-block (per-slot) partials added in a fixed
// order (no float atomics, so two runs agree bit for bit); the per-plane
// reduction sums are per-block partials added in order in double. The
// spilled tensors (xin, up, raw1, raw2, gy2, gy1) live in device memory.
// Unlike the whole-plane kernels (fused_decoder_bwd.cu), no whole-plane
// statistic is recomputed: GroupNorm normalises with the statistics the
// forward saved (decoder_gn_stats), bit-identical to those it normalised
// with.

#include "decoder_stage_bwd.cuh"

namespace {

// g_c = bf16(rstd (gamma g_y - mga - x_hat mgb)) over (P, C, HW) planes,
// with x_hat from the raw input c and the saved statistics; mga, mgb [P][C].
__global__ void __launch_bounds__(NT)
gn_solve_kernel(const bf16* __restrict__ g_y, const bf16* __restrict__ c, int C, int HW,
                GNIn gn, const float* __restrict__ mga, const float* __restrict__ mgb,
                bf16* __restrict__ g_c) {
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
    g_c[i] = __float2bfloat16(
        s_rstd[g] * (gn.gamma[ch] * __bfloat162float(g_y[i]) - mga[v] - xh * mgb[v]));
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
              (const float*)rstd, 0};
}

// gy = g_a (bf16) masked by the ReLU of GN(c), stored in bf16 (gy may alias
// g_a), and its per-plane reduction sums [P][C][2] (gpart: P * C * ceil(HW
// / NT) * 2 floats of scratch).
void relu_mask_and_sums(const bf16* g_a, const bf16* c, int P, int C, int HW, const GNIn& gn,
                        bf16* gy, float* gpart, float* sums, cudaStream_t st) {
  const int eb = (HW + NT - 1) / NT;
  gn_bwd_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(g_a, c, C, HW, gn, gy, gpart);
  plane_sums_kernel<<<(P * C + NT - 1) / NT, NT, 0, st>>>(gpart, P * C, eb, sums);
}

// D_PITCH: the row pitch of pass C's phase-separated g_up; D_SKIP_HALF: 1
// (0 leaves conv1's skip half out of pass A's recompute, a planted fault);
// D_WG_PLANES: the planes pass B's conv2 wgrad reduces over (P; fewer only
// for a planted fault); D_SLOTS*: slots of the igemm weight-gradient
// reductions (pass A's head; pass B's conv2; pass C's conv1 up half, skip
// half and transpose conv).
enum Dim {
  D_P, D_CIN, D_H, D_W, D_B, D_CS, D_CU, D_COUT, D_PITCH, D_SKIP_HALF, D_WG_PLANES, D_SLOTS,
  D_SLOTS2, D_SLOTS3, D_COUNT
};

enum ASlot {
  A_X, A_GX_MEAN, A_GX_RSTD, A_GX_GAMMA, A_GX_BETA, A_SKIP, A_UP_W, A_UP_B, A_W1U, A_W1S, A_W2,
  A_G1W, A_G1B, A_G2W, A_G2B, A_M1, A_R1, A_M2, A_R2, A_HEAD_WD, A_G_OUT, A_G_A2,
  A_XIN, A_UP, A_YS, A_RAW1, A_RAW2, A_A1, A_A2, A_GY2, A_GPART, A_SUMS, A_WPART, A_BPART,
  A_SCR_A, A_SCR_B, A_SCR_G, A_G_HW, A_G_HB, A_COUNT
};
enum BSlot {
  B_RAW1, B_RAW2, B_GY2, B_M1, B_R1, B_M2, B_R2, B_G1W, B_G1B, B_G2W, B_G2B, B_MGA, B_MGB,
  B_W2_D, B_GRAW2, B_A1, B_GY1, B_GPART, B_SUMS, B_WPART, B_SCR_A, B_SCR_B, B_G_W2, B_COUNT
};
enum CSlot {
  C_XIN, C_UP, C_SKIP, C_RAW1, C_GY1, C_M1, C_R1, C_G1W, C_G1B, C_MGA, C_MGB, C_UP_W,
  C_W1U_D, C_W1S_D, C_GRAW1, C_G_UP, C_G_IMG, C_WPART, C_BPART, C_SCR_A, C_SCR_B, C_G_XIN,
  C_G_SKIP, C_G_W1U, C_G_W1S, C_G_UP_W, C_G_UP_B, C_COUNT
};

}  // namespace

// Pass A of one stage. Inputs: x (P, cin, h, w) bf16, raw when A_GX_MEAN is
// set (then GN+ReLU with the saved A_GX_* statistics and affine gives xin,
// written to A_XIN; otherwise A_XIN is x itself); skip (B, cs, H, W) bf16;
// the weights in the igemm layouts (bf16): A_UP_W [4][cu][cin] (phase ky *
// 2 + kx), A_W1U [9][cout][cu], A_W1S [9][cout][cs], A_W2 [9][cout][cout];
// A_UP_B float32 [cu]; the stage's saved statistics m1, r1, m2, r2 (P,
// cout); the gradient: with A_HEAD_WD (the head's float32 dgrad weights
// [1][9][cout]) the logits' gradient A_G_OUT (P, 1, H, W), else A_G_A2 (P,
// cout, H, W), the gradient of GN2+ReLU(raw2), both bf16. Outputs: A_UP (P,
// cu, H, W), A_RAW1, A_RAW2, A_GY2 (P, cout, H, W) bf16; A_SUMS (P, cout,
// 2) float32; with the head A_G_HW [9][cout][16] (column 0), A_G_HB [1]
// (and A_G_A2 is written). Scratch: A_YS (B, cout, H, W) float32; A_A1 and
// (head) A_A2 bf16 (P, cout, H, W); A_GPART (P, cout, ceil(H W / 256), 2);
// (head) A_WPART (D_SLOTS, 9, cout, 16), A_BPART (P), A_SCR_B as A_SCR_A,
// A_SCR_G bf16 P H tma_pitch(W); A_SCR_A bf16, room for the three
// column-shifted copies of the largest source (3 P C H tma_pitch(W)).
// Returns the first CUDA error of the launches.
extern "C" int banded_pass_a(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], cout = d[D_COUT];
  const int HW = 4 * h * w;
  if (cout > GSIZE * MAXG) return (int)cudaErrorInvalidValue;   // GNIn's chunks
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const Stage s{P, cin, h, w, d[D_B], d[D_CS], d[D_CU], cout};
  const GNIn gn1 = saved(t[A_G1W], t[A_G1B], t[A_M1], t[A_R1]);
  const GNIn gn2 = saved(t[A_G2W], t[A_G2B], t[A_M2], t[A_R2]);

  if (t[A_GX_MEAN] != nullptr) {
    const GNIn gx = saved(t[A_GX_GAMMA], t[A_GX_BETA], t[A_GX_MEAN], t[A_GX_RSTD]);
    gn_relu_kernel<<<dim3((h * w + NT - 1) / NT, P), NT, 0, st>>>(b16(A_X), cin, h * w, gx,
                                                                   b16(A_XIN));
  }
  // recompute up, raw1 and raw2 (no partial sums: the statistics are saved)
  Planes a1;
  SEMIVL_CK(stage_recompute(s, b16(A_XIN), b16(A_SKIP), b16(A_UP_W), f(A_UP_B), b16(A_W1U),
                            b16(A_W1S), b16(A_W2), d[D_SKIP_HALF] != 0, gn1, b16(A_UP), f(A_YS),
                            b16(A_RAW1), nullptr, b16(A_A1), b16(A_RAW2), nullptr,
                            b16(A_SCR_A), &a1, st));
  if (t[A_HEAD_WD] != nullptr)
    SEMIVL_CK(head_bwd(s, b16(A_RAW2), gn2, b16(A_G_OUT), f(A_HEAD_WD), b16(A_A2), b16(A_G_A2),
                       f(A_WPART), d[D_SLOTS], f(A_G_HW), f(A_BPART), f(A_G_HB), b16(A_SCR_B),
                       b16(A_SCR_G), st));
  relu_mask_and_sums(b16(A_G_A2), b16(A_RAW2), P, cout, HW, gn2, b16(A_GY2), f(A_GPART),
                     f(A_SUMS), st);
  return (int)cudaGetLastError();
}

// Pass B of one stage. Inputs: raw1, raw2 and gy2 (P, cout, H, W) bf16
// from pass A; the saved statistics; gamma/beta of both GroupNorms; the
// closed GN2 vectors B_MGA, B_MGB (P, cout); conv2's dgrad weights B_W2_D
// in the igemm layout, bf16 [9][cout][cout] (flipped, transposed).
// Outputs: B_GY1 (P, cout, H, W) bf16, B_SUMS (P, cout, 2), B_G_W2 [9]
// [cout][cout]. Scratch: B_GRAW2 and B_A1 bf16 (P, cout, H, W), B_GPART
// (P, cout, ceil(H W / 256), 2), B_WPART (D_SLOTS, 9, cout, cout), B_SCR_A
// and B_SCR_B bf16, each room for the three column-shifted copies of a
// (P, cout, H, W) source (3 P cout H tma_pitch(W)). d[D_H], d[D_W] are the
// stage's INPUT grid (the planes are twice that). Returns the first CUDA
// error of the launches.
extern "C" int banded_pass_b(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], h = d[D_H], w = d[D_W], cout = d[D_COUT];
  const int H = 2 * h, W = 2 * w, HW = H * W, eb = (HW + NT - 1) / NT;
  if (cout > GSIZE * MAXG) return (int)cudaErrorInvalidValue;   // GNIn's chunks
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const GNIn gn1 = saved(t[B_G1W], t[B_G1B], t[B_M1], t[B_R1]);
  const GNIn gn2 = saved(t[B_G2W], t[B_G2B], t[B_M2], t[B_R2]);

  gn_solve_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(B_GY2), b16(B_RAW2), cout, HW, gn2, f(B_MGA),
                                               f(B_MGB), b16(B_GRAW2));
  gn_relu_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(B_RAW1), cout, HW, gn1, b16(B_A1));
  const Planes a1 = igemm::shifted_source(b16(B_A1), P, cout, H, W, b16(B_SCR_A), st);
  SEMIVL_CK(conv2_bwd(Stage{P, 0, h, w, 0, 0, 0, cout}, b16(B_GRAW2), a1, b16(B_W2_D),
                      d[D_WG_PLANES], d[D_SLOTS], f(B_WPART), b16(B_GY1), f(B_G_W2),
                      b16(B_SCR_B), st));                                 // g_a1 into gy1
  relu_mask_and_sums(b16(B_GY1), b16(B_RAW1), P, cout, HW, gn1, b16(B_GY1), f(B_GPART),
                     f(B_SUMS), st);
  return (int)cudaGetLastError();
}

// Pass C of one stage. Inputs: xin (P, cin, h, w) and up (P, cu, H, W) bf16
// from pass A, the skip, raw1 and gy1 (bf16); the saved GN1 statistics and
// gamma; the closed GN1 vectors C_MGA, C_MGB; the dgrad weights in the
// igemm layouts (bf16): the transpose conv's C_UP_W [cin][4 cu], conv1's
// C_W1U_D [9][cu][cout] and C_W1S_D [9][cs][cout]. Outputs: C_G_XIN (P,
// cin, h, w) bf16; float32 C_G_SKIP (B, cs, H, W), C_G_W1U [9][cu][cout],
// C_G_W1S [9][cs][cout], C_G_UP_W [4 cu][cin], C_G_UP_B [cu]. Scratch (bf16
// but the last two): C_GRAW1 (P, cout, H, W); C_G_UP [P][4][cu][h][D_PITCH]
// (g_up, phase-separated); C_G_IMG (B, cout, H, W); C_SCR_A, C_SCR_B as
// pass A's A_SCR_A; C_WPART (the largest of the three wgrads' slots x
// weights), C_BPART (P, cu). Returns the first CUDA error of the launches.
extern "C" int banded_pass_c(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], h = d[D_H], w = d[D_W], B = d[D_B], cout = d[D_COUT];
  const int HW = 4 * h * w, eb = (HW + NT - 1) / NT;
  if (cout > GSIZE * MAXG) return (int)cudaErrorInvalidValue;   // GNIn's chunks
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const GNIn gn1 = saved(t[C_G1W], t[C_G1B], t[C_M1], t[C_R1]);

  gn_solve_kernel<<<dim3(eb, P), NT, 0, st>>>(b16(C_GY1), b16(C_RAW1), cout, HW, gn1, f(C_MGA),
                                               f(C_MGB), b16(C_GRAW1));
  const int slots[3] = {d[D_SLOTS], d[D_SLOTS2], d[D_SLOTS3]};
  return stage_input_bwd(Stage{P, d[D_CIN], h, w, B, d[D_CS], d[D_CU], cout}, b16(C_GRAW1),
                         b16(C_UP), b16(C_XIN), b16(C_SKIP), b16(C_UP_W), b16(C_W1U_D),
                         b16(C_W1S_D), d[D_PITCH], slots, B, b16(C_G_UP), b16(C_G_IMG),
                         f(C_WPART), f(C_BPART), b16(C_SCR_A), b16(C_SCR_B), b16(C_G_XIN),
                         f(C_G_SKIP), f(C_G_W1U), f(C_G_W1S), f(C_G_UP_W), f(C_G_UP_B), st);
}
