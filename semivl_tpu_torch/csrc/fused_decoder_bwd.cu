// Fused VLG decoder Up stage backward for Hopper (sm_90a), the whole-plane
// route.
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
// What bounds it on this card: the convolutions' dgrads and wgrads (and
// the recompute of the forward), ~440 GFLOP at the flagship training shape
// (P = 126 planes), so the tensor cores. Every product of more than one
// input channel runs on decoder_igemm.cuh's wgmma implicit GEMM (bf16
// operands, float32 sums, TMA rings): the recompute (transpose conv per
// output phase, conv1's skip half per image, conv1's up half with the skip
// addend and GroupNorm partials in its epilogue, conv2 with its partials),
// every 3x3 dgrad (the same product with flipped, transposed weights) and
// wgrad (K = pixels, per-slot partials added in a fixed order: no float
// atomics, two runs agree bit for bit), and the transpose conv's dgrad (K
// = 4 cu) and wgrad (K = input pixels). The head's dgrad (32 -> 1
// channel, K = 9) stays on decoder_common.cuh's CUDA cores, as do the
// elementwise passes; its wgrad runs on the wgrad kernel at N = 16. The
// recompute, the head, conv2's backward and the input half are
// decoder_stage_bwd.cuh's sequences, which the banded passes
// (fused_decoder_banded.cu) share.
//
// GroupNorm+ReLU backward: a separate elementwise pass (gn_backward below:
// per-slab sums of g_y and g_y x_hat, a per-plane reduction in double, the
// apply pass g_raw = rstd (gamma g_y - A - x_hat B)) rather than fused into
// the dgrad epilogue and the consumers' loads. The consumers read their
// operands straight from TMA into the swizzled tiles, so a transform on
// load would cost a shared-memory pass in every K step; the separate pass
// reads and writes each plane once.
//
// Storage, as JAX's kernels store (_CDT = bf16): the gradients of the
// normalised conv2 output (g_a2), of the raw conv2 output (g_raw2), of the
// normalised conv1 output (g_a1), of the raw conv1 output (g_raw1, the
// tail -> input hand-off) and of the stage input (g_x) are bf16. Two more
// bf16 operands that JAX's polyphase kernels never form are the transpose
// conv's output gradient (g_up, a wgmma operand, kept phase-separated
// [P][4][cu][h][pitch] for the transpose conv's GEMMs) and the per-image
// sum of g_raw1 (g_img, the skip half's operand); the rounded reference
// (ops/fused_decoder.py::fused_vlg_decoder_rounded) rounds there too.
// g_skip and every weight, bias and GroupNorm gradient are float32.
//
// Design against the TPU kernels. They kept a plane in VMEM, recomputed the
// forward there and accumulated weight gradients across a sequential grid.
// Here blocks run in parallel, so the stage is a sequence of kernels on the
// stream: nothing is saved from the forward but the stage inputs; the
// recompute and the gradients between the steps live in device memory.

#include "decoder_stage_bwd.cuh"

namespace {

// Tensor slots of decoder_stage_bwd_tail (t[]) and its sizes (d[]).
enum TailSlot {
  T_X, T_GN_PART, T_GN_GAMMA, T_GN_BETA, T_SKIP, T_UP_WF, T_UP_B, T_W1U, T_W1S, T_W2,
  T_G1W, T_G1B, T_G2W, T_G2B, T_W2_D, T_HEAD_WD, T_G_OUT, T_G_A2,
  T_XIN, T_UP, T_YS, T_C1, T_PART1, T_C2, T_PART2, T_A1, T_A2, T_G_RAW2, T_G_A1,
  T_GPART, T_GSUM, T_GAB, T_BPART, T_IGPART, T_SCR_A, T_SCR_B, T_SCR_G,
  T_G_C1, T_G_W2, T_G_G1W, T_G_G1B, T_G_G2W, T_G_G2B, T_G_HW, T_G_HB, T_COUNT
};
enum InputSlot {
  I_G_C1, I_UP, I_XIN, I_SKIP, I_UP_WD, I_W1U_D, I_W1S_D, I_GPH, I_G_IMG, I_IGPART, I_BPART,
  I_SCR_A, I_SCR_B, I_G_XIN, I_G_SKIP, I_G_W1U, I_G_W1S, I_G_UP_W, I_G_UP_B, I_COUNT
};
// D_PITCH: the row pitch of the phase-separated g_up (input half);
// D_WG_PLANES: the planes the tail's conv2 wgrad reduces over (P; fewer
// only for a planted fault); D_SLOTS*: slots of each wgrad reduction.
// D_GS, D_GS_IN: channels per GroupNorm group of the output and of a
// normalised input (16 but where a group lies zero-padded: GNIn::gk).
enum Dim {
  D_P, D_CIN, D_H, D_W, D_GN_NPARTS, D_B, D_CS, D_CU, D_COUT, D_PITCH, D_WG_PLANES, D_SLOTS,
  D_SLOTS2, D_SLOTS3, D_GS, D_GS_IN, D_COUNT
};

// ------------------------------------------------ GroupNorm+ReLU backward

constexpr int GN_SLAB = 1024;   // pixels of one block of gn_bwd_sums_kernel
constexpr int GN_MAXC = GSIZE * MAXG;   // the widest normalised plane (512 channels)

// g_y = g_a [gamma x_hat + beta > 0] from the raw input c; per (plane,
// channel, slab) sums of g_y and g_y x_hat: gpart[p][c][slab][2].
__global__ void __launch_bounds__(NT)
gn_bwd_sums_kernel(const bf16* __restrict__ g_a, const bf16* __restrict__ c, int C, int HW,
                   GNIn gn, float* __restrict__ gpart) {
  __shared__ float s_mean[MAXG], s_rstd[MAXG];
  __shared__ float s_part[NT / 32][GN_MAXC][2];
  const int p = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  gn_prologue(gn, p, C / GSIZE, s_mean, s_rstd);
  for (int ch = 0; ch < C; ++ch) {
    const int g = ch / GSIZE;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int j = 0; j < GN_SLAB / NT; ++j) {
      const int pix = blockIdx.x * GN_SLAB + j * NT + threadIdx.x;
      if (pix < HW) {
        const size_t i = ((size_t)p * C + ch) * HW + pix;
        const float v = __bfloat162float(c[i]);
        if (gn_affine(gn, ch, v, s_mean, s_rstd) > 0.f) {
          const float gy = __bfloat162float(g_a[i]);
          s += gy;
          q += gy * ((v - s_mean[g]) * s_rstd[g]);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      s_part[warp][ch][0] = s;
      s_part[warp][ch][1] = q;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < C; ch += NT) {
    float s = 0.f, q = 0.f;
    for (int w = 0; w < NT / 32; ++w) {
      s += s_part[w][ch][0];
      q += s_part[w][ch][1];
    }
    float* o = gpart + (((size_t)p * C + ch) * gridDim.x + blockIdx.x) * 2;
    o[0] = s;
    o[1] = q;
  }
}

// Per plane (block): the channel totals gsum[p][c][2] (g_y, g_y x_hat),
// summed over the slabs in order in double, and per group A = sum gamma g_y
// / n and B = sum gamma g_y x_hat / n (n = gs H W), on each of the group's
// chunks: gab[p][chunk][2].
__global__ void gn_bwd_reduce_kernel(const float* __restrict__ gpart, int C, int nslabs, GNIn gn,
                                     float* __restrict__ gsum, float* __restrict__ gab) {
  __shared__ double s_a[GN_MAXC], s_b[GN_MAXC];
  const int p = blockIdx.x, ch = threadIdx.x;
  if (ch < C) {
    const float* q = gpart + ((size_t)p * C + ch) * nslabs * 2;
    double a = 0.0, b = 0.0;
    for (int s = 0; s < nslabs; ++s) {
      a += q[2 * s];
      b += q[2 * s + 1];
    }
    gsum[((size_t)p * C + ch) * 2] = (float)a;
    gsum[((size_t)p * C + ch) * 2 + 1] = (float)b;
    s_a[ch] = gn.gamma[ch] * a;
    s_b[ch] = gn.gamma[ch] * b;
  }
  __syncthreads();
  const int chunks = C / GSIZE, gk = gn.gk > 1 ? gn.gk : 1;
  if (ch < chunks) {
    double a = 0.0, b = 0.0;
    const int first = ch / gk * gk;
    for (int k = first * GSIZE; k < (first + gk) * GSIZE; ++k) {
      a += s_a[k];
      b += s_b[k];
    }
    gab[((size_t)p * chunks + ch) * 2] = (float)(a * gn.inv_count);
    gab[((size_t)p * chunks + ch) * 2 + 1] = (float)(b * gn.inv_count);
  }
}

// GroupNorm parameter gradients: per channel, the planes' totals in order.
__global__ void gn_bwd_params_kernel(const float* __restrict__ gsum, int P, int C,
                                     float* __restrict__ g_gamma, float* __restrict__ g_beta) {
  const int ch = threadIdx.x;
  if (ch >= C) return;
  double b = 0.0, g = 0.0;
  for (int p = 0; p < P; ++p) {
    b += gsum[((size_t)p * C + ch) * 2];
    g += gsum[((size_t)p * C + ch) * 2 + 1];
  }
  g_beta[ch] = (float)b;
  g_gamma[ch] = (float)g;
}

// g_raw = rstd (gamma g_y - A - x_hat B), stored in bf16.
__global__ void __launch_bounds__(NT)
gn_bwd_apply_kernel(const bf16* __restrict__ g_a, const bf16* __restrict__ c, int C, int HW,
                    GNIn gn, const float* __restrict__ gab, bf16* __restrict__ g_raw) {
  __shared__ float s_mean[MAXG], s_rstd[MAXG], s_a[MAXG], s_b[MAXG];
  const int p = blockIdx.y, groups = C / GSIZE;
  if (threadIdx.x < groups) {
    s_a[threadIdx.x] = gab[((size_t)p * groups + threadIdx.x) * 2];
    s_b[threadIdx.x] = gab[((size_t)p * groups + threadIdx.x) * 2 + 1];
  }
  gn_prologue(gn, p, groups, s_mean, s_rstd);   // ends in __syncthreads
  const int pix = blockIdx.x * NT + threadIdx.x;
  if (pix >= HW) return;
  for (int ch = 0; ch < C; ++ch) {
    const size_t i = ((size_t)p * C + ch) * HW + pix;
    const int g = ch / GSIZE;
    const float v = __bfloat162float(c[i]);
    const float xh = (v - s_mean[g]) * s_rstd[g];
    const float gy = gn_affine(gn, ch, v, s_mean, s_rstd) > 0.f ? __bfloat162float(g_a[i]) : 0.f;
    g_raw[i] = __float2bfloat16(s_rstd[g] * (gn.gamma[ch] * gy - s_a[g] - xh * s_b[g]));
  }
}

// GN+ReLU backward from g_a (the normalised output's gradient) to g_raw,
// with the scale and shift gradients. gpart: P * C * ceil(HW / GN_SLAB) * 2
// floats; gsum: P * C * 2; gab: P * C / 16 * 2.
int gn_backward(const bf16* g_a, const bf16* c, int P, int C, int HW, const GNIn& gn,
                float* gpart, float* gsum, float* gab, bf16* g_raw, float* g_gamma,
                float* g_beta, cudaStream_t st) {
  if (C > GN_MAXC) return (int)cudaErrorInvalidValue;
  const int slabs = (HW + GN_SLAB - 1) / GN_SLAB;
  gn_bwd_sums_kernel<<<dim3(slabs, P), NT, 0, st>>>(g_a, c, C, HW, gn, gpart);
  gn_bwd_reduce_kernel<<<P, GN_MAXC, 0, st>>>(gpart, C, slabs, gn, gsum, gab);
  gn_bwd_params_kernel<<<1, GN_MAXC, 0, st>>>(gsum, P, C, g_gamma, g_beta);
  gn_bwd_apply_kernel<<<dim3((HW + NT - 1) / NT, P), NT, 0, st>>>(g_a, c, C, HW, gn, gab, g_raw);
  return (int)cudaGetLastError();
}

}  // namespace

// The tail of one stage's backward. The stage is the forward's
// decoder_stage_fwd with the same inputs (x, optional GN on load from the
// previous stage's partials T_GN_PART / T_GN_GAMMA / T_GN_BETA, skip) and
// its weights in the igemm layouts (bf16): T_UP_WF [4][cu][cin] (phase ky
// * 2 + kx), T_W1U [9][cout][cu], T_W1S [9][cout][cs], T_W2 [9][cout]
// [cout], T_W2_D the same for conv2's dgrad (flipped, transposed); T_UP_B
// float32 [cu]. The gradient comes in as g_out (the head logits' gradient,
// bf16 (P, 1, H, W), when T_HEAD_WD holds the head's float32 dgrad weights
// [1][9][cout]) or as T_G_A2 (bf16 (P, cout, H, W), the gradient of
// GN2+ReLU(conv2)). Outputs: T_G_C1 (bf16 g_raw1), g_w2 [9][cout][cout],
// g_hw [9][cout][16] (column 0 the head's), g_hb [1], and the GroupNorm
// scale/shift gradients
// [cout]. T_XIN (GN+ReLU of x when T_GN_PART is set, else x itself) and
// T_UP (the recomputed transpose conv output) are left for
// decoder_stage_bwd_input. Scratch: T_YS float32 (B, cout, H, W); T_C1,
// T_C2, T_A1, T_A2, T_G_RAW2, T_G_A1 bf16 (P, cout, H, W) (T_G_A2 too with
// the head); T_PART1, T_PART2 (P, cout / 16, tiles, 2) with tiles =
// ceil(H / 4) ceil(W / 64); the GroupNorm backward's T_GPART, T_GSUM,
// T_GAB (see gn_backward); T_IGPART (D_SLOTS, 9 cout max(cout, 16)) for
// conv2's and the head's wgrad, T_BPART (P) for the head's bias; T_SCR_G
// (bf16 P H tma_pitch(W)) for g_out at a TMA pitch; T_SCR_A and
// T_SCR_B, bf16, each room for the three column-shifted copies of the
// largest source (3 P C H tma_pitch(W), C the largest width).
// Returns the first CUDA error of the launches.
extern "C" int decoder_stage_bwd_tail(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT];
  const int H = 2 * h, W = 2 * w, HW = H * W;
  const int tiles = ((H + igemm::CONV_ROWS - 1) / igemm::CONV_ROWS) *
                    ((W + igemm::TW - 1) / igemm::TW);
  if ((t[T_GN_PART] != nullptr && cin > GSIZE * MAXG) || cout > GSIZE * MAXG)
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };

  if (t[T_GN_PART] != nullptr) {
    const GNIn gx = gn_parts(f(T_GN_PART), f(T_GN_GAMMA), f(T_GN_BETA), d[D_GN_NPARTS],
                             d[D_GS_IN], h, w);
    gn_relu_kernel<<<dim3((h * w + NT - 1) / NT, P), NT, 0, st>>>(b16(T_X), cin, h * w, gx,
                                                                   b16(T_XIN));
  }
  // 1. recompute the stage forward from its inputs
  const Stage s{P, cin, h, w, B, cs, cu, cout};
  const GNIn gn1 = gn_parts(f(T_PART1), f(T_G1W), f(T_G1B), tiles, d[D_GS], H, W);
  const GNIn gn2 = gn_parts(f(T_PART2), f(T_G2W), f(T_G2B), tiles, d[D_GS], H, W);
  Planes a1;
  SEMIVL_CK(stage_recompute(s, b16(T_XIN), b16(T_SKIP), b16(T_UP_WF), f(T_UP_B), b16(T_W1U),
                            b16(T_W1S), b16(T_W2), true, gn1, b16(T_UP), f(T_YS), b16(T_C1),
                            f(T_PART1), b16(T_A1), b16(T_C2), f(T_PART2), b16(T_SCR_A), &a1,
                            st));
  // 2. the head: g_a2 = dgrad(g_out) on the CUDA cores (K = 9); its weight
  // gradient on the wgrad kernel at N = 16 (column 0 is g_out's), its bias
  // gradient the sum of g_out
  if (t[T_HEAD_WD] != nullptr)
    SEMIVL_CK(head_bwd(s, b16(T_C2), gn2, b16(T_G_OUT), f(T_HEAD_WD), b16(T_A2), b16(T_G_A2),
                       f(T_IGPART), d[D_SLOTS], f(T_G_HW), f(T_BPART), f(T_G_HB), b16(T_SCR_B),
                       b16(T_SCR_G), st));
  // 3. GN2+ReLU backward -> g_raw2
  SEMIVL_CK(gn_backward(b16(T_G_A2), b16(T_C2), P, cout, HW, gn2, f(T_GPART), f(T_GSUM),
                        f(T_GAB), b16(T_G_RAW2), f(T_G_G2W), f(T_G_G2B), st));
  // 4. conv2: g_a1 = dgrad(g_raw2), g_w2 = wgrad(a1, g_raw2)
  SEMIVL_CK(conv2_bwd(s, b16(T_G_RAW2), a1, b16(T_W2_D), d[D_WG_PLANES], d[D_SLOTS],
                      f(T_IGPART), b16(T_G_A1), f(T_G_W2), b16(T_SCR_B), st));
  // 5. GN1+ReLU backward -> g_raw1
  SEMIVL_CK(gn_backward(b16(T_G_A1), b16(T_C1), P, cout, HW, gn1, f(T_GPART), f(T_GSUM),
                        f(T_GAB), b16(T_G_C1), f(T_G_G1W), f(T_G_G1B), st));
  return (int)cudaGetLastError();
}

// The input half of one stage's backward, from g_raw1 (I_G_C1, bf16 (P,
// cout, H, W)): conv1's up half (dgrad -> the phase-separated g_up I_GPH,
// bf16 [P][4][cu][h][pitch]; wgrad over all planes -> I_G_W1U [9][cu]
// [cout]), its skip half on the per-image sum of g_raw1 (I_G_IMG, bf16;
// dgrad -> I_G_SKIP float32 (B, cs, H, W), wgrad -> I_G_W1S [9][cs][cout])
// and the transpose conv (I_G_XIN (P, cin, h, w) bf16, I_G_UP_W [4 cu]
// [cin], I_G_UP_B [cu]). I_UP and I_XIN are the tail's recomputed tensors;
// I_W1U_D [9][cu][cout] and I_W1S_D [9][cs][cout] are conv1's dgrad
// weights, I_UP_WD [cin][4 cu] the transpose conv's (bf16). Scratch:
// I_IGPART (the largest of the three wgrads' slots x weights), I_BPART (P,
// cu), I_SCR_A / I_SCR_B as the tail's. Returns the first CUDA error of
// the launches.
extern "C" int decoder_stage_bwd_input(void* const* t, const int* d, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int P = d[D_P], cin = d[D_CIN], h = d[D_H], w = d[D_W], B = d[D_B], cs = d[D_CS];
  const int cu = d[D_CU], cout = d[D_COUT];
  auto f = [&](int i) { return (float*)t[i]; };
  auto b16 = [&](int i) { return (bf16*)t[i]; };
  const int slots[3] = {d[D_SLOTS], d[D_SLOTS2], d[D_SLOTS3]};
  return stage_input_bwd(Stage{P, cin, h, w, B, cs, cu, cout}, b16(I_G_C1), b16(I_UP),
                         b16(I_XIN), b16(I_SKIP), b16(I_UP_WD), b16(I_W1U_D), b16(I_W1S_D),
                         d[D_PITCH], slots, B, b16(I_GPH), b16(I_G_IMG), f(I_IGPART),
                         f(I_BPART), b16(I_SCR_A), b16(I_SCR_B), b16(I_G_XIN), f(I_G_SKIP),
                         f(I_G_W1U), f(I_G_W1S), f(I_G_UP_W), f(I_G_UP_B), st);
}

