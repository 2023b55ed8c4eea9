// Device code of the decoder backward's elementwise steps: the
// GroupNorm+ReLU backward's first half (the banded passes,
// fused_decoder_banded.cu) and the ordered sum of weight-gradient partials
// that both backward routes use (no float atomics).
#pragma once

#include "decoder_common.cuh"

namespace {

// GN+ReLU backward, first half: g_y = g_a * [gamma x_hat + beta > 0] from
// the raw input c, bf16 in and out (g_y may alias g_a), and per (plane,
// channel, block) partial sums of g_y and g_y * x_hat: gpart[p][c]
// [blockIdx.x][2].
__global__ void __launch_bounds__(NT)
gn_bwd_relu_kernel(const bf16* g_a, const bf16* __restrict__ c, int C, int HW, GNIn gn,
                   bf16* g_y, float* __restrict__ gpart) {
  __shared__ float s_mean[MAXG], s_rstd[MAXG];
  __shared__ float2 s_red[NT / 32];
  const int p = blockIdx.y;
  gn_prologue(gn, p, C / GSIZE, s_mean, s_rstd);
  const int pix = blockIdx.x * NT + threadIdx.x;
  for (int ch = 0; ch < C; ++ch) {
    float gy = 0.f, gyx = 0.f;
    if (pix < HW) {
      const size_t i = ((size_t)p * C + ch) * HW + pix;
      const int g = ch / GSIZE;
      const float v = __bfloat162float(c[i]);
      const float xh = (v - s_mean[g]) * s_rstd[g];
      gy = gn_affine(gn, ch, v, s_mean, s_rstd) > 0.f ? __bfloat162float(g_a[i]) : 0.f;
      g_y[i] = __float2bfloat16(gy);
      gyx = gy * xh;
    }
    const float2 r = block_sum2(gy, gyx, s_red);
    if (threadIdx.x == 0) {
      float* o = gpart + (((size_t)p * C + ch) * gridDim.x + blockIdx.x) * 2;
      o[0] = r.x;
      o[1] = r.y;
    }
  }
}

// out[m] = sum_r part[r][m], r in order.
__global__ void sum_partials_kernel(const float* __restrict__ part, int R, int M,
                                    float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[(size_t)r * M + m];
  out[m] = s;
}

void sum_partials(const float* part, int R, int M, float* out, cudaStream_t st) {
  sum_partials_kernel<<<(M + NT - 1) / NT, NT, 0, st>>>(part, R, M, out);
}

// out[m][n] (row stride ld) = sum_r part[r][m][n] for n < ncols, r in
// order: a column group's wgrad partials [R][M][N] into its columns of a
// wider weight gradient.
__global__ void sum_partial_cols_kernel(const float* __restrict__ part, int R, int M, int N,
                                        int ncols, int ld, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * ncols) return;
  const int m = i / ncols, n = i % ncols;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[((size_t)r * M + m) * N + n];
  out[(size_t)m * ld + n] = s;
}

void sum_partial_cols(const float* part, int R, int M, int N, int ncols, int ld, float* out,
                      cudaStream_t st) {
  sum_partial_cols_kernel<<<(M * ncols + NT - 1) / NT, NT, 0, st>>>(part, R, M, N, ncols, ld,
                                                                     out);
}

}  // namespace
