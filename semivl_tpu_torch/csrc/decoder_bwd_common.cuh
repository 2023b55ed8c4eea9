// Device code of the banded decoder backward (fused_decoder_banded.cu, the
// three-pass backward from saved GroupNorm statistics), some of it shared
// with the whole-plane backward (fused_decoder_bwd.cu): the GroupNorm+ReLU
// backward's first half, the 3x3 conv and 2x2 transpose-conv weight
// gradients (per-block partials added in a fixed order, no float atomics)
// and the transpose conv input gradient, all in float32 on the CUDA cores.
#pragma once

#include "decoder_common.cuh"

namespace {

constexpr int WT = 8;   // wgrad tile side (8x8 output pixels per item)
constexpr int TW = 4;   // tconv wgrad tile side (4x4 input pixels per item)
constexpr int TD_CU = 8;

__host__ __device__ constexpr int wgrad_ciw(int cout) {
  return (NT / (cout >= 4 ? cout / 4 : cout)) < 64 ? NT / (cout >= 4 ? cout / 4 : cout) : 64;
}

// GN+ReLU backward, first half: g_y = g_a * [gamma x_hat + beta > 0] from
// the raw input c (g_y may alias g_a), and per (plane, channel, block)
// partial sums of g_y and g_y * x_hat: gpart[p][c][blockIdx.x][2].
__global__ void __launch_bounds__(NT)
gn_bwd_relu_kernel(const float* g_a, const bf16* __restrict__ c, int C, int HW, GNIn gn,
                   float* g_y, float* __restrict__ gpart) {
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
      gy = gn_affine(gn, ch, v, s_mean, s_rstd) > 0.f ? g_a[i] : 0.f;
      g_y[i] = gy;
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

// out[b][j] = sum_n g[b * N + n][j] for j < per: the gradient of the
// per-image skip term, summed over the image's N class planes.
__global__ void plane_sum_kernel(const float* __restrict__ g, int N, size_t per, int B,
                                 float* __restrict__ out) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= (size_t)B * per) return;
  const size_t b = i / per, j = i % per;
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += g[(b * N + n) * per + j];
  out[i] = s;
}

// Weight gradient of a 3x3 / padding-1 convolution over planes (P, cin, H,
// W), partial over this block's share (every gridDim.y-th) of the (plane,
// 8x8 tile) items: part[blockIdx.y][ci][9][COUT] = sum g[p][co][pix] *
// in[p][ci][pix + tap - 1]; with bpart also bpart[blockIdx.y][COUT] = sum g
// (a bias gradient). A thread owns one input channel and VEC output
// channels over the 9 taps; grid x walks the input channels.
template <int COUT, typename TG>
__global__ void __launch_bounds__(NT)
wgrad3x3_kernel(const TG* __restrict__ g, const bf16* __restrict__ in, int P, int cin, int H,
                int W, float* __restrict__ part, float* __restrict__ bpart) {
  constexpr int VEC = COUT >= 4 ? 4 : 1;
  constexpr int NCO = COUT / VEC;
  constexpr int CIW = wgrad_ciw(COUT);
  __shared__ __align__(16) float s_g[WT * WT][COUT];
  __shared__ float s_in[CIW][WT + 2][WT + 2];
  const int co0 = (threadIdx.x % NCO) * VEC, cil = threadIdx.x / NCO;
  const int ci = blockIdx.x * CIW + cil;
  const bool active = cil < CIW && ci < cin;
  const int tiles_x = (W + WT - 1) / WT, tiles = tiles_x * ((H + WT - 1) / WT);
  const size_t hw = (size_t)H * W;

  float acc[9][VEC], accb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    accb[j] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[t][j] = 0.f;
  }

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
        float gv[VEC];
        if constexpr (VEC == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(&s_g[pix][co0]);
          gv[0] = v4.x;
          gv[1] = v4.y;
          gv[2] = v4.z;
          gv[3] = v4.w;
        } else {
          gv[0] = s_g[pix][co0];
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float xv = s_in[cil][py + t / 3][px + t % 3];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[t][j] += xv * gv[j];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) accb[j] += gv[j];
      }
    }
  }
  if (active) {
    float* o = part + ((size_t)blockIdx.y * cin + ci) * 9 * COUT + co0;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[t * COUT + j] = acc[t][j];
  }
  if (bpart != nullptr && blockIdx.x == 0 && cil == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) bpart[(size_t)blockIdx.y * COUT + co0 + j] = accb[j];
  }
}

// Input gradient of the 2x2 stride-2 transpose conv:
//   g_x[p][ci][y][x] = sum_{cu,ky,kx} g_up[p][cu][2y+ky][2x+kx] W[ci][ky*2+kx][cu],
// w float32 [cin][4][cu]; one thread per input pixel, CIT input channels
// per block (grid z).
__global__ void __launch_bounds__(NT)
tconv_dgrad_kernel(const float* __restrict__ g_up, int cu, int h, int w_in,
                   const float* __restrict__ w, int cin, float* __restrict__ g_x) {
  __shared__ float s_g[TD_CU][2 * TILE][2 * TILE + 1];
  __shared__ __align__(16) float s_w[TD_CU][4][CIT];
  const int p = blockIdx.y, cz = blockIdx.z * CIT;
  const int H = 2 * h, W = 2 * w_in;
  const int tiles_x = (w_in + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int y = ty0 + ly, x = tx0 + lx;
  const size_t hw_out = (size_t)H * W;

  float acc[CIT];
#pragma unroll
  for (int j = 0; j < CIT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cu; c0 += TD_CU) {
    __syncthreads();
    for (int i = threadIdx.x; i < TD_CU * 4 * TILE * TILE; i += NT) {
      const int c = i / (4 * TILE * TILE);
      const int r = (i / (2 * TILE)) % (2 * TILE), col = i % (2 * TILE);
      const int oy = 2 * ty0 + r, ox = 2 * tx0 + col;
      s_g[c][r][col] = (c0 + c < cu && oy < H && ox < W)
                           ? g_up[((size_t)p * cu + c0 + c) * hw_out + (size_t)oy * W + ox]
                           : 0.f;
    }
    for (int i = threadIdx.x; i < TD_CU * 4 * CIT; i += NT) {
      const int j = i % CIT, k = (i / CIT) % 4, c = i / (4 * CIT);
      s_w[c][k][j] = (c0 + c < cu) ? w[((size_t)(cz + j) * 4 + k) * cu + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < TD_CU; ++c) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = s_g[c][2 * ly + k / 2][2 * lx + k % 2];
        const float4* wp = reinterpret_cast<const float4*>(&s_w[c][k][0]);
#pragma unroll
        for (int j = 0; j < CIT / 4; ++j) {
          const float4 wv = wp[j];
          acc[4 * j] += v * wv.x;
          acc[4 * j + 1] += v * wv.y;
          acc[4 * j + 2] += v * wv.z;
          acc[4 * j + 3] += v * wv.w;
        }
      }
    }
  }
  if (y < h && x < w_in) {
    const size_t hw_in = (size_t)h * w_in, pix = (size_t)y * w_in + x;
#pragma unroll
    for (int j = 0; j < CIT; ++j) g_x[((size_t)p * cin + cz + j) * hw_in + pix] = acc[j];
  }
}

// Weight and bias gradient of the transpose conv, partial over this block's
// share of the (plane, 4x4 input tile) items:
//   part[blockIdx.y][ci][k][CU] = sum xin[p][ci][y][x] g_up[p][cu][2y+ky][2x+kx],
//   bpart[blockIdx.y][CU] = sum g_up (blocks with blockIdx.x == 0).
template <int CU>
__global__ void __launch_bounds__(NT)
tconv_wgrad_kernel(const bf16* __restrict__ xin, const float* __restrict__ g_up, int P,
                   int cin, int h, int w_in, float* __restrict__ part,
                   float* __restrict__ bpart) {
  constexpr int NCO = CU / 4;
  constexpr int CIW = NT / NCO;
  __shared__ __align__(16) float s_g[TW * TW][4][CU];
  __shared__ float s_x[CIW][TW * TW];
  const int cu0 = (threadIdx.x % NCO) * 4, cil = threadIdx.x / NCO;
  const int ci = blockIdx.x * CIW + cil;
  const bool active = cil < CIW && ci < cin;
  const int H = 2 * h, W = 2 * w_in;
  const int tiles_x = (w_in + TW - 1) / TW, tiles = tiles_x * ((h + TW - 1) / TW);
  const size_t hw_in = (size_t)h * w_in, hw_out = (size_t)H * W;

  float acc[4][4], accb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    accb[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][j] = 0.f;
  }

  for (int item = blockIdx.y; item < P * tiles; item += gridDim.y) {
    const int p = item / tiles, tile = item % tiles;
    const int ty0 = (tile / tiles_x) * TW, tx0 = (tile % tiles_x) * TW;
    __syncthreads();
    for (int i = threadIdx.x; i < CU * 4 * TW * TW; i += NT) {
      const int c = i / (4 * TW * TW);
      const int r = (i / (2 * TW)) % (2 * TW), col = i % (2 * TW);
      const int oy = 2 * ty0 + r, ox = 2 * tx0 + col;
      s_g[(r / 2) * TW + col / 2][(r % 2) * 2 + col % 2][c] =
          (oy < H && ox < W) ? g_up[((size_t)p * CU + c) * hw_out + (size_t)oy * W + ox] : 0.f;
    }
    for (int i = threadIdx.x; i < CIW * TW * TW; i += NT) {
      const int c = i / (TW * TW), q = i % (TW * TW);
      const int y = ty0 + q / TW, x = tx0 + q % TW, cc = blockIdx.x * CIW + c;
      s_x[c][q] = (cc < cin && y < h && x < w_in)
                      ? __bfloat162float(xin[((size_t)p * cin + cc) * hw_in + (size_t)y * w_in + x])
                      : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int q = 0; q < TW * TW; ++q) {
        const float xv = s_x[cil][q];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 g4 = *reinterpret_cast<const float4*>(&s_g[q][k][cu0]);
          acc[k][0] += xv * g4.x;
          acc[k][1] += xv * g4.y;
          acc[k][2] += xv * g4.z;
          acc[k][3] += xv * g4.w;
          accb[0] += g4.x;
          accb[1] += g4.y;
          accb[2] += g4.z;
          accb[3] += g4.w;
        }
      }
    }
  }
  if (active) {
    float* o = part + ((size_t)blockIdx.y * cin + ci) * 4 * CU + cu0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[k * CU + j] = acc[k][j];
  }
  if (blockIdx.x == 0 && cil == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) bpart[(size_t)blockIdx.y * CU + cu0 + j] = accb[j];
  }
}

void sum_partials(const float* part, int R, int M, float* out, cudaStream_t st) {
  sum_partials_kernel<<<(M + NT - 1) / NT, NT, 0, st>>>(part, R, M, out);
}

// Weight gradient (and bias gradient when bout is set) of a 3x3 conv whose
// output gradient g has `cout` channels: out [cin][9][cout].
template <int COUT, typename TG>
void launch_wgrad(const TG* g, const bf16* in, int P, int cin, int H, int W, int R, float* part,
                  float* bpart, float* out, float* bout, cudaStream_t st) {
  constexpr int CIW = wgrad_ciw(COUT);
  wgrad3x3_kernel<COUT, TG><<<dim3((cin + CIW - 1) / CIW, R), NT, 0, st>>>(
      g, in, P, cin, H, W, part, bout != nullptr ? bpart : nullptr);
  sum_partials(part, R, cin * 9 * COUT, out, st);
  if (bout != nullptr) sum_partials(bpart, R, COUT, bout, st);
}

template <typename TG>
void wgrad(int cout, const TG* g, const bf16* in, int P, int cin, int H, int W, int R,
           float* part, float* bpart, float* out, float* bout, cudaStream_t st) {
  switch (cout) {
    case 1: launch_wgrad<1, TG>(g, in, P, cin, H, W, R, part, bpart, out, bout, st); break;
    case 16: launch_wgrad<16, TG>(g, in, P, cin, H, W, R, part, bpart, out, bout, st); break;
    case 32: launch_wgrad<32, TG>(g, in, P, cin, H, W, R, part, bpart, out, bout, st); break;
    case 64: launch_wgrad<64, TG>(g, in, P, cin, H, W, R, part, bpart, out, bout, st); break;
  }
}

template <int CU>
void launch_tconv_wgrad(const bf16* xin, const float* g_up, int P, int cin, int h, int w,
                        int R, float* part, float* bpart, float* out, float* bout,
                        cudaStream_t st) {
  constexpr int CIW = NT / (CU / 4);
  tconv_wgrad_kernel<CU><<<dim3((cin + CIW - 1) / CIW, R), NT, 0, st>>>(xin, g_up, P, cin, h,
                                                                          w, part, bpart);
  sum_partials(part, R, cin * 4 * CU, out, st);
  sum_partials(bpart, R, CU, bout, st);
}

void tconv_wgrad(int cu, const bf16* xin, const float* g_up, int P, int cin, int h, int w,
                 int R, float* part, float* bpart, float* out, float* bout, cudaStream_t st) {
  switch (cu) {
    case 16: launch_tconv_wgrad<16>(xin, g_up, P, cin, h, w, R, part, bpart, out, bout, st); break;
    case 32: launch_tconv_wgrad<32>(xin, g_up, P, cin, h, w, R, part, bpart, out, bout, st); break;
    case 48: launch_tconv_wgrad<48>(xin, g_up, P, cin, h, w, R, part, bpart, out, bout, st); break;
    case 64: launch_tconv_wgrad<64>(xin, g_up, P, cin, h, w, R, part, bpart, out, bout, st); break;
    case 96: launch_tconv_wgrad<96>(xin, g_up, P, cin, h, w, R, part, bpart, out, bout, st); break;
  }
}

}  // namespace
