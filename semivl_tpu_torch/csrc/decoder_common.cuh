// Device code shared by the fused VLG decoder kernels (fused_decoder.cu,
// the forward and the fused Up stage; fused_decoder_bwd.cu and
// fused_decoder_banded.cu, the two backward routes), on the CUDA cores in
// float32: GroupNorm statistics reduced from per-tile partial sums or read
// as saved, GroupNorm+ReLU as its own pass, and the direct 3x3 convolution
// to or from one channel (the head's forward and its input gradient; every
// wider product runs on decoder_igemm.cuh's tensor cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 16;          // output tile side (one pixel per thread)
constexpr int NT = TILE * TILE;   // 256 threads
constexpr int HALO = TILE + 2;
constexpr int CI = 8;             // input channels per shared-memory chunk
constexpr int GSIZE = 16;         // GroupNorm channels per chunk (C / 16 chunks)
constexpr int MAXG = 32;          // chunks of a normalised plane, at most (C <= 512)

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// GroupNorm + ReLU applied to an input as it is loaded. The channels lie
// in chunks of GSIZE; a group of gs channels fills gk = ceil(gs / 16)
// chunks, its gs channels first and zero channels (zero weights, gamma and
// beta) after them, so that sums over its chunks are sums over the group.
// The statistics are either reduced from the producer's per-tile partials,
// [plane][chunk][tile][2] (part), or read as saved (mean, rstd:
// [plane][channel] float32, one value per group repeated over its
// channels), as the banded backward takes them from the forward.
struct GNIn {
  const float* part;   // null (and mean null): no normalisation
  const float* gamma;
  const float* beta;
  int nparts;
  float inv_count;     // 1 / (gs * H * W)
  const float* mean;   // saved statistics; take precedence over part
  const float* rstd;
  int gk;              // chunks per group (0: 1)
};

// GroupNorm by partials `part` over groups of gs channels of an h x w
// plane (gk and inv_count from gs).
inline GNIn gn_parts(const float* part, const float* gamma, const float* beta, int nparts,
                     int gs, int h, int w) {
  return GNIn{part, gamma, beta, nparts, 1.f / ((float)gs * (float)h * (float)w), nullptr,
              nullptr, (gs + GSIZE - 1) / GSIZE};
}

__device__ __forceinline__ bool gn_on(const GNIn& gn) {
  return gn.part != nullptr || gn.mean != nullptr;
}

// Mean and 1/sqrt(var + eps) of one group from its nparts (sum, sum of
// squares) partials, summed in order in double. The forward's prologue and
// the statistics it saves for the backward both come from here, so they
// agree bit for bit.
__device__ __forceinline__ void gn_group_stats(const float* p, int nparts, float inv_count,
                                               float* mean_out, float* rstd_out) {
  double s = 0.0, ss = 0.0;
  for (int t = 0; t < nparts; ++t) {
    s += p[2 * t];
    ss += p[2 * t + 1];
  }
  const double mean = s * inv_count;
  double var = ss * inv_count - mean * mean;
  var = var > 0.0 ? var : 0.0;
  *mean_out = (float)mean;
  *rstd_out = (float)(1.0 / sqrt(var + 1e-5));
}

// s_mean, s_rstd [chunk] of one plane of `chunks` chunks: each chunk its
// group's statistics (a group's partials are its chunks', one after
// another).
__device__ void gn_prologue(const GNIn& gn, int plane, int chunks, float* s_mean,
                            float* s_rstd) {
  if (threadIdx.x < chunks) {
    const size_t pg = (size_t)plane * chunks + threadIdx.x;
    if (gn.mean != nullptr) {
      s_mean[threadIdx.x] = gn.mean[pg * GSIZE];
      s_rstd[threadIdx.x] = gn.rstd[pg * GSIZE];
    } else if (gn.part != nullptr) {
      const int gk = gn.gk > 1 ? gn.gk : 1;
      const size_t first = (size_t)plane * chunks + threadIdx.x / gk * gk;
      gn_group_stats(gn.part + first * gn.nparts * 2, gk * gn.nparts, gn.inv_count,
                     &s_mean[threadIdx.x], &s_rstd[threadIdx.x]);
    }
  }
  __syncthreads();
}

// Pre-activation GroupNorm output gamma * x_hat + beta of channel c.
__device__ __forceinline__ float gn_affine(const GNIn& gn, int c, float v, const float* s_mean,
                                           const float* s_rstd) {
  const int g = c / GSIZE;
  return (v - s_mean[g]) * s_rstd[g] * gn.gamma[c] + gn.beta[c];
}

__device__ __forceinline__ float gn_apply(const GNIn& gn, int c, float v, const float* s_mean,
                                          const float* s_rstd) {
  return bf16_round(fmaxf(gn_affine(gn, c, v, s_mean, s_rstd), 0.f));  // stored in bf16
}

// Block-wide sum of (a, b) over 256 threads; thread 0 gets the result.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // s_red is reused across calls
  if ((threadIdx.x & 31) == 0) s_red[warp] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) {
      r.x += s_red[w].x;
      r.y += s_red[w].y;
    }
  return r;
}

// 3x3 convolution, padding 1, over bf16 planes (P, cin, H, W) into COUT
// channels of bf16 (P, ocs, H, W) planes from `out` on. w: float32 [cin]
// [9][wld], its first COUT columns. Optional: GroupNorm+ReLU on the input
// (gn) and a bias. Any cin >= 1 is taken.
template <int COUT>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const bf16* __restrict__ in, int cin, int H, int W, GNIn gn,
               const float* __restrict__ w, int wld, const float* __restrict__ bias,
               bf16* __restrict__ out, int ocs) {
  __shared__ float s_in[CI][HALO][HALO + 1];
  __shared__ __align__(16) float s_w[CI * 9 * COUT];
  __shared__ float s_mean[MAXG], s_rstd[MAXG];

  const int p = blockIdx.y;
  const int tiles_x = (W + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int oy = ty0 + ly, ox = tx0 + lx;
  const bool valid = oy < H && ox < W;
  const size_t hw = (size_t)H * W;

  gn_prologue(gn, p, cin / GSIZE, s_mean, s_rstd);

  float acc[COUT];
#pragma unroll
  for (int j = 0; j < COUT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CI) {
    __syncthreads();
    for (int i = threadIdx.x; i < CI * HALO * HALO; i += NT) {
      const int c = i / (HALO * HALO), r = (i / HALO) % HALO, col = i % HALO;
      const int y = ty0 - 1 + r, x = tx0 - 1 + col;
      float v = 0.f;  // zero padding applies after the activation
      if (c0 + c < cin && y >= 0 && y < H && x >= 0 && x < W) {
        v = __bfloat162float(in[((size_t)p * cin + c0 + c) * hw + (size_t)y * W + x]);
        if (gn_on(gn)) v = gn_apply(gn, c0 + c, v, s_mean, s_rstd);
      }
      s_in[c][r][col] = v;
    }
    const int wlen = min(CI, cin - c0) * 9 * COUT;
    for (int i = threadIdx.x; i < CI * 9 * COUT; i += NT)
      s_w[i] = i < wlen ? w[((size_t)c0 * 9 + i / COUT) * wld + i % COUT] : 0.f;
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < CI; ++c) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float xv = s_in[c][ly + t / 3][lx + t % 3];
        const float* wp = &s_w[(c * 9 + t) * COUT];
        if constexpr (COUT % 4 == 0) {
#pragma unroll
          for (int j = 0; j < COUT / 4; ++j) {
            const float4 wv = reinterpret_cast<const float4*>(wp)[j];
            acc[4 * j] += xv * wv.x;
            acc[4 * j + 1] += xv * wv.y;
            acc[4 * j + 2] += xv * wv.z;
            acc[4 * j + 3] += xv * wv.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < COUT; ++j) acc[j] += xv * wp[j];
        }
      }
    }
  }

  if (!valid) return;
  const size_t pix = (size_t)oy * W + ox;
#pragma unroll
  for (int j = 0; j < COUT; ++j)
    out[((size_t)p * ocs + j) * hw + pix] =
        __float2bfloat16(bias != nullptr ? acc[j] + bias[j] : acc[j]);
}

// out = GN+ReLU(in), bf16, over (P, C, HW) planes.
__global__ void __launch_bounds__(NT)
gn_relu_kernel(const bf16* __restrict__ in, int C, int HW, GNIn gn, bf16* __restrict__ out) {
  __shared__ float s_mean[MAXG], s_rstd[MAXG];
  const int p = blockIdx.y;
  gn_prologue(gn, p, C / GSIZE, s_mean, s_rstd);
  const int pix = blockIdx.x * NT + threadIdx.x;
  if (pix >= HW) return;
  for (int c = 0; c < C; ++c) {
    const size_t i = ((size_t)p * C + c) * HW + pix;
    out[i] = __float2bfloat16(gn_apply(gn, c, __bfloat162float(in[i]), s_mean, s_rstd));
  }
}

// Dispatch on the output channel count: 1 (the head's forward) or a
// multiple of 16 (its input gradient, one per stage width), in column
// groups of 96, 64, 48, 32 or 16 (the widest that fits what is left);
// another count is an error (returned; the launch's own errors come from
// cudaGetLastError).
int conv(int cout, const bf16* in, int planes, int cin, int H, int W, GNIn gn,
          const float* w, const float* bias, bf16* out, cudaStream_t st) {
  const dim3 grid(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), planes);
  if (cout == 1) {
    conv3x3_kernel<1><<<grid, NT, 0, st>>>(in, cin, H, W, gn, w, 1, bias, out, 1);
    return 0;
  }
  if (cout % 16 || bias != nullptr) return (int)cudaErrorInvalidValue;
  const size_t hw = (size_t)H * W;
  for (int n0 = 0, n; n0 < cout; n0 += n) {
    const int left = cout - n0;
    n = left >= 96 ? 96 : left >= 64 ? 64 : left >= 48 ? 48 : left >= 32 ? 32 : 16;
    const float* wn = w + n0;
    bf16* on = out + n0 * hw;
    switch (n) {
      case 16: conv3x3_kernel<16><<<grid, NT, 0, st>>>(in, cin, H, W, gn, wn, cout, nullptr, on, cout); break;
      case 32: conv3x3_kernel<32><<<grid, NT, 0, st>>>(in, cin, H, W, gn, wn, cout, nullptr, on, cout); break;
      case 48: conv3x3_kernel<48><<<grid, NT, 0, st>>>(in, cin, H, W, gn, wn, cout, nullptr, on, cout); break;
      case 64: conv3x3_kernel<64><<<grid, NT, 0, st>>>(in, cin, H, W, gn, wn, cout, nullptr, on, cout); break;
      default: conv3x3_kernel<96><<<grid, NT, 0, st>>>(in, cin, H, W, gn, wn, cout, nullptr, on, cout); break;
    }
  }
  return 0;
}

constexpr GNIn NO_GN{nullptr, nullptr, nullptr, 0, 0.f, nullptr, nullptr, 0};

}  // namespace
