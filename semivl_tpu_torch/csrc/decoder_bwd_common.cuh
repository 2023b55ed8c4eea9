// Device code of the banded decoder backward's CUDA-core steps
// (fused_decoder_banded.cu: pass B's conv2 weight gradient, the
// GroupNorm+ReLU backward's first half) and the ordered sum of weight-
// gradient partials that both backward routes use (no float atomics).
#pragma once

#include "decoder_common.cuh"

namespace {

constexpr int WT = 8;   // wgrad tile side (8x8 output pixels per item)

__host__ __device__ constexpr int wgrad_ciw(int cout) {
  return NT / (cout / 4) < 64 ? NT / (cout / 4) : 64;
}

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

// Weight gradient of a 3x3 / padding-1 convolution over planes (P, cin, H,
// W), partial over this block's share (every gridDim.y-th) of the (plane,
// 8x8 tile) items: part[blockIdx.y][ci][9][COUT] = sum g[p][co][pix] *
// in[p][ci][pix + tap - 1]. A thread owns one input channel and 4 output
// channels over the 9 taps; grid x walks the input channels.
template <int COUT>
__global__ void __launch_bounds__(NT)
wgrad3x3_kernel(const bf16* __restrict__ g, const bf16* __restrict__ in, int P, int cin, int H,
                int W, float* __restrict__ part) {
  constexpr int NCO = COUT / 4;
  constexpr int CIW = wgrad_ciw(COUT);
  __shared__ __align__(16) float s_g[WT * WT][COUT];
  __shared__ float s_in[CIW][WT + 2][WT + 2];
  const int co0 = (threadIdx.x % NCO) * 4, cil = threadIdx.x / NCO;
  const int ci = blockIdx.x * CIW + cil;
  const bool active = cil < CIW && ci < cin;
  const int tiles_x = (W + WT - 1) / WT, tiles = tiles_x * ((H + WT - 1) / WT);
  const size_t hw = (size_t)H * W;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;

  for (int item = blockIdx.y; item < P * tiles; item += gridDim.y) {
    const int p = item / tiles, tile = item % tiles;
    const int ty0 = (tile / tiles_x) * WT, tx0 = (tile % tiles_x) * WT;
    __syncthreads();
    for (int i = threadIdx.x; i < WT * WT * COUT; i += NT) {
      const int co = i / (WT * WT), pix = i % (WT * WT);
      const int y = ty0 + pix / WT, x = tx0 + pix % WT;
      s_g[pix][co] = (y < H && x < W) ? ld(g, ((size_t)p * COUT + co) * hw + (size_t)y * W + x)
                                      : 0.f;
    }
    for (int i = threadIdx.x; i < CIW * (WT + 2) * (WT + 2); i += NT) {
      const int c = i / ((WT + 2) * (WT + 2));
      const int r = (i / (WT + 2)) % (WT + 2), col = i % (WT + 2);
      const int y = ty0 - 1 + r, x = tx0 - 1 + col, cc = blockIdx.x * CIW + c;
      s_in[c][r][col] = (cc < cin && y >= 0 && y < H && x >= 0 && x < W)
                            ? ld(in, ((size_t)p * cin + cc) * hw + (size_t)y * W + x)
                            : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 2
      for (int pix = 0; pix < WT * WT; ++pix) {
        const int py = pix / WT, px = pix % WT;
        const float4 gv = *reinterpret_cast<const float4*>(&s_g[pix][co0]);
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float xv = s_in[cil][py + t / 3][px + t % 3];
          acc[t][0] += xv * gv.x;
          acc[t][1] += xv * gv.y;
          acc[t][2] += xv * gv.z;
          acc[t][3] += xv * gv.w;
        }
      }
    }
  }
  if (active) {
    float* o = part + ((size_t)blockIdx.y * cin + ci) * 9 * COUT + co0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[t * COUT + j] = acc[t][j];
  }
}

void sum_partials(const float* part, int R, int M, float* out, cudaStream_t st) {
  sum_partials_kernel<<<(M + NT - 1) / NT, NT, 0, st>>>(part, R, M, out);
}

// Weight gradient of a 3x3 conv whose output gradient g has `cout` (16,
// 32 or 64) channels: out [cin][9][cout], from R blocks' partials (part:
// R cin 9 cout floats) added in order.
template <int COUT>
void launch_wgrad(const bf16* g, const bf16* in, int P, int cin, int H, int W, int R,
                  float* part, float* out, cudaStream_t st) {
  constexpr int CIW = wgrad_ciw(COUT);
  wgrad3x3_kernel<COUT><<<dim3((cin + CIW - 1) / CIW, R), NT, 0, st>>>(g, in, P, cin, H, W,
                                                                         part);
  sum_partials(part, R, cin * 9 * COUT, out, st);
}

void wgrad(int cout, const bf16* g, const bf16* in, int P, int cin, int H, int W, int R,
           float* part, float* out, cudaStream_t st) {
  switch (cout) {
    case 16: launch_wgrad<16>(g, in, P, cin, H, W, R, part, out, st); break;
    case 32: launch_wgrad<32>(g, in, P, cin, H, W, R, part, out, st); break;
    case 64: launch_wgrad<64>(g, in, P, cin, H, W, R, part, out, st); break;
  }
}

}  // namespace
