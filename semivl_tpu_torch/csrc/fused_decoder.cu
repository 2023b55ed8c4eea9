// Fused VLG decoder Up stage forward for Hopper (sm_90a).
//
// Replaces semivl_tpu/ops/fused_decoder.py::_stage_fwd_kernel (the Pallas
// TPU kernel behind fused_vlg_decoder): per class plane, the 2x2 stride-2
// transpose conv, conv1 3x3 over [up(x), skip], GroupNorm -> ReLU ->
// conv2 3x3 -> GroupNorm -> ReLU, and on the last stage the 3x3 head to one
// channel with bias. Storage between the convs is bf16; accumulation and
// GroupNorm statistics are float32 (double for the final reduction).
//
// What bounds it on this card: the flagship decoder (P = 42 planes, x
// 128x32x32 -> 1x128x128) does about 72 GFLOP on about 15 MB of inputs and
// outputs, so it is bound by operations. This first version computes on the
// CUDA cores in float32 (register-tiled direct convolution: each thread owns
// one output pixel and all output channels, weights stream through shared
// memory as float4 broadcasts), which is right but far from the tensor-core
// bound; implicit GEMM on the tensor cores is later work.
//
// Design against the TPU kernel. The TPU kernel kept a whole plane in VMEM
// (megabytes) and ran the grid in order; a stage-2 plane is 32x128x128, 1 MB
// per conv output in bf16, more than a block's shared memory, and blocks
// run in parallel. So one stage is a short sequence of kernels on the
// stream, each over (16x16 output tile, plane) blocks:
//   1. tconv2x2: up = x (*) W + b, bf16. The input may carry the previous
//      stage's GroupNorm+ReLU, applied as it is loaded.
//   2. conv3x3 on the skip, once per IMAGE (the skip is shared by the N
//      class planes of an image, as _SplitSkipConv computes it), float32.
//   3. conv3x3 over up, plus the skip term of the plane's image -> raw
//      conv1 output (bf16) and per-(plane, group, tile) partial sums.
//   4. conv3x3 over GN1+ReLU(conv1), applied on load -> raw conv2 + sums.
//   5. last stage only: the head conv over GN2+ReLU(conv2), plus bias.
// GroupNorm statistics need the whole plane: each conv block writes its
// tile's (sum, sum of squares) per group (no atomics), and the consumer's
// prologue reduces the plane's partials in double (the second pass). A
// stage that ends without the head hands its raw conv2 and partial sums to
// the next stage, whose tconv applies GN2+ReLU on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 16;          // output tile side (one pixel per thread)
constexpr int NT = TILE * TILE;   // 256 threads
constexpr int HALO = TILE + 2;
constexpr int CI = 8;             // input channels per shared-memory chunk
constexpr int GSIZE = 16;         // GroupNorm channels per group (C / 16 groups)
constexpr int MAXG = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// GroupNorm + ReLU applied to an input as it is loaded: the statistics are
// reduced from the producer's per-tile partials, [plane][group][tile][2].
struct GNIn {
  const float* part;   // null: no normalisation
  const float* gamma;
  const float* beta;
  int nparts;
  float inv_count;     // 1 / (GSIZE * H * W)
};

__device__ void gn_prologue(const GNIn& gn, int plane, int groups, float* s_mean,
                            float* s_rstd) {
  if (gn.part != nullptr && threadIdx.x < groups) {
    const float* p = gn.part + ((size_t)plane * groups + threadIdx.x) * gn.nparts * 2;
    double s = 0.0, ss = 0.0;
    for (int t = 0; t < gn.nparts; ++t) {
      s += p[2 * t];
      ss += p[2 * t + 1];
    }
    const double mean = s * gn.inv_count;
    double var = ss * gn.inv_count - mean * mean;
    var = var > 0.0 ? var : 0.0;
    s_mean[threadIdx.x] = (float)mean;
    s_rstd[threadIdx.x] = (float)(1.0 / sqrt(var + 1e-5));
  }
  __syncthreads();
}

__device__ __forceinline__ float gn_apply(const GNIn& gn, int c, float v, const float* s_mean,
                                          const float* s_rstd) {
  const int g = c / GSIZE;
  v = (v - s_mean[g]) * s_rstd[g] * gn.gamma[c] + gn.beta[c];
  return bf16_round(fmaxf(v, 0.f));  // activations are stored in bf16
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

// 3x3 convolution, padding 1, over planes (P, cin, H, W) in bf16.
// w: float32 [cin][9][COUT]. Optional: GroupNorm+ReLU on the input (gn),
// a float32 addend add[(p / add_rep)][COUT][H][W], a bias, and per-tile
// group partial sums of the output (stats: [P][COUT/16][tiles][2]).
// Writes bf16 (out_h) or float32 (out_f).
template <int COUT>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const bf16* __restrict__ in, int cin, int H, int W, GNIn gn,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ add, int add_rep, bf16* __restrict__ out_h,
               float* __restrict__ out_f, float* __restrict__ stats) {
  __shared__ float s_in[CI][HALO][HALO + 1];
  __shared__ __align__(16) float s_w[CI * 9 * COUT];
  __shared__ float s_mean[MAXG], s_rstd[MAXG];
  __shared__ float2 s_red[NT / 32];

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
      if (y >= 0 && y < H && x >= 0 && x < W) {
        v = __bfloat162float(in[((size_t)p * cin + c0 + c) * hw + (size_t)y * W + x]);
        if (gn.part != nullptr) v = gn_apply(gn, c0 + c, v, s_mean, s_rstd);
      }
      s_in[c][r][col] = v;
    }
    for (int i = threadIdx.x; i < CI * 9 * COUT; i += NT)
      s_w[i] = w[(size_t)c0 * 9 * COUT + i];
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

  const size_t pix = (size_t)oy * W + ox;
  if (valid) {
    if (add != nullptr) {
      const float* a = add + (size_t)(p / add_rep) * COUT * hw + pix;
#pragma unroll
      for (int j = 0; j < COUT; ++j) acc[j] += a[j * hw];
    }
    if (bias != nullptr) {
#pragma unroll
      for (int j = 0; j < COUT; ++j) acc[j] += bias[j];
    }
#pragma unroll
    for (int j = 0; j < COUT; ++j) {
      if (out_h != nullptr) {
        const bf16 o = __float2bfloat16(acc[j]);
        out_h[((size_t)p * COUT + j) * hw + pix] = o;
        acc[j] = __bfloat162float(o);  // statistics of the stored values
      } else {
        out_f[((size_t)p * COUT + j) * hw + pix] = acc[j];
      }
    }
  }
  if (stats != nullptr) {
    const int groups = COUT / GSIZE, ntiles = gridDim.x;
#pragma unroll
    for (int g = 0; g < COUT / GSIZE; ++g) {
      float s = 0.f, ss = 0.f;
      if (valid) {
#pragma unroll
        for (int j = g * GSIZE; j < (g + 1) * GSIZE; ++j) {
          s += acc[j];
          ss += acc[j] * acc[j];
        }
      }
      const float2 r = block_sum2(s, ss, s_red);
      if (threadIdx.x == 0) {
        float* o = stats + (((size_t)p * groups + g) * ntiles + blockIdx.x) * 2;
        o[0] = r.x;
        o[1] = r.y;
      }
    }
  }
}

// 2x2 stride-2 transpose conv: up[p][cu][2y+ky][2x+kx] =
//   b[cu] + sum_ci x[p][ci][y][x] * W[ci][cu][ky][kx].
// w: float32 [cin][4 = ky*2+kx][cu]; CU_T output channels per block (grid z).
constexpr int CU_T = 16;
constexpr int CIT = 32;

__global__ void __launch_bounds__(NT)
tconv2x2_kernel(const bf16* __restrict__ in, int cin, int h, int w_in, GNIn gn,
                const float* __restrict__ w, const float* __restrict__ bias, int cu,
                bf16* __restrict__ out) {
  __shared__ float s_in[CIT][TILE / 2][TILE / 2 + 1];
  __shared__ __align__(16) float s_w[CIT * 4 * CU_T];
  __shared__ float s_mean[MAXG], s_rstd[MAXG];

  const int p = blockIdx.y, cz = blockIdx.z * CU_T;
  const int H = 2 * h, W = 2 * w_in;
  const int tiles_x = (W + TILE - 1) / TILE;
  const int ty0 = (blockIdx.x / tiles_x) * TILE, tx0 = (blockIdx.x % tiles_x) * TILE;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int oy = ty0 + ly, ox = tx0 + lx;
  const int ph = (oy & 1) * 2 + (ox & 1);
  const size_t hw_in = (size_t)h * w_in;

  gn_prologue(gn, p, cin / GSIZE, s_mean, s_rstd);

  float acc[CU_T];
#pragma unroll
  for (int j = 0; j < CU_T; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += CIT) {
    __syncthreads();
    for (int i = threadIdx.x; i < CIT * (TILE / 2) * (TILE / 2); i += NT) {
      const int c = i / ((TILE / 2) * (TILE / 2));
      const int r = (i / (TILE / 2)) % (TILE / 2), col = i % (TILE / 2);
      const int y = ty0 / 2 + r, x = tx0 / 2 + col;
      float v = 0.f;
      if (y < h && x < w_in) {
        v = __bfloat162float(in[((size_t)p * cin + c0 + c) * hw_in + (size_t)y * w_in + x]);
        if (gn.part != nullptr) v = gn_apply(gn, c0 + c, v, s_mean, s_rstd);
      }
      s_in[c][r][col] = v;
    }
    for (int i = threadIdx.x; i < CIT * 4 * CU_T; i += NT) {
      const int j = i % CU_T, rest = i / CU_T;  // rest = c * 4 + phase
      s_w[i] = w[((size_t)c0 * 4 + rest) * cu + cz + j];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < CIT; ++c) {
      const float xv = s_in[c][ly / 2][lx / 2];
      const float4* wp = reinterpret_cast<const float4*>(&s_w[(c * 4 + ph) * CU_T]);
#pragma unroll
      for (int j = 0; j < CU_T / 4; ++j) {
        const float4 wv = wp[j];
        acc[4 * j] += xv * wv.x;
        acc[4 * j + 1] += xv * wv.y;
        acc[4 * j + 2] += xv * wv.z;
        acc[4 * j + 3] += xv * wv.w;
      }
    }
  }
  if (oy < H && ox < W) {
    const size_t hw = (size_t)H * W, pix = (size_t)oy * W + ox;
#pragma unroll
    for (int j = 0; j < CU_T; ++j)
      out[((size_t)p * cu + cz + j) * hw + pix] = __float2bfloat16(acc[j] + bias[cz + j]);
  }
}

template <int COUT>
void launch_conv(const bf16* in, int planes, int cin, int H, int W, GNIn gn, const float* w,
                 const float* bias, const float* add, int add_rep, bf16* out_h, float* out_f,
                 float* stats, cudaStream_t st) {
  dim3 grid(((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE), planes);
  conv3x3_kernel<COUT><<<grid, NT, 0, st>>>(in, cin, H, W, gn, w, bias, add, add_rep, out_h,
                                            out_f, stats);
}

void conv(int cout, const bf16* in, int planes, int cin, int H, int W, GNIn gn,
          const float* w, const float* bias, const float* add, int add_rep, bf16* out_h,
          float* out_f, float* stats, cudaStream_t st) {
  switch (cout) {
    case 1: launch_conv<1>(in, planes, cin, H, W, gn, w, bias, add, add_rep, out_h, out_f, stats, st); break;
    case 16: launch_conv<16>(in, planes, cin, H, W, gn, w, bias, add, add_rep, out_h, out_f, stats, st); break;
    case 32: launch_conv<32>(in, planes, cin, H, W, gn, w, bias, add, add_rep, out_h, out_f, stats, st); break;
    case 64: launch_conv<64>(in, planes, cin, H, W, gn, w, bias, add, add_rep, out_h, out_f, stats, st); break;
  }
}

}  // namespace

// One Up stage (plus the head when head_w is not null) over P = B * n_rep
// planes. Shapes (all NCHW, contiguous):
//   x (P, cin, h, w) bf16, optionally still raw: gn_part/gn_gamma/gn_beta
//     (the previous stage's conv2 partials) apply GN+ReLU on load;
//   skip (B, cs, 2h, 2w) bf16;
//   up_w float32 [cin][4][cu], up_b [cu];
//   w1u [cu][9][cout], w1s [cs][9][cout], w2 [cout][9][cout] float32;
//   g1w, g1b, g2w, g2b [cout]; head_w [cout][9][1], head_b [1];
//   scratch: up (P, cu, 2h, 2w) bf16, ys (B, cout, 2h, 2w) float32,
//     c1 (P, cout, 2h, 2w) bf16, part1 / part2 (P, cout/16, tiles, 2);
//   out: c2 raw (P, cout, 2h, 2w) bf16, or head logits (P, 1, 2h, 2w) bf16.
// cin, cs, cu and cout are multiples of 16 (cout in {16, 32, 64}, cin and cu
// of 32 for the transpose conv, cin, cs, cu and cout of 8 for the convs).
// Returns cudaGetLastError() after the launches.
extern "C" int decoder_stage_fwd(
    const void* x, int P, int cin, int h, int w, const void* gn_part, const void* gn_gamma,
    const void* gn_beta, int gn_nparts, const void* skip, int B, int cs, const void* up_w,
    const void* up_b, int cu, const void* w1u, const void* w1s, const void* w2, int cout,
    const void* g1w, const void* g1b, const void* g2w, const void* g2b, const void* head_w,
    const void* head_b, void* up, void* ys, void* c1, void* part1, void* part2, void* c2,
    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int H = 2 * h, W = 2 * w;
  const int tiles = ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
  const float inv_in = 1.f / (GSIZE * (float)h * (float)w);
  const float inv_out = 1.f / (GSIZE * (float)H * (float)W);
  const GNIn none{nullptr, nullptr, nullptr, 0, 0.f};

  GNIn gn_x{(const float*)gn_part, (const float*)gn_gamma, (const float*)gn_beta, gn_nparts,
            inv_in};
  tconv2x2_kernel<<<dim3(tiles, P, cu / CU_T), NT, 0, st>>>(
      (const bf16*)x, cin, h, w, gn_x, (const float*)up_w, (const float*)up_b, cu, (bf16*)up);
  conv(cout, (const bf16*)skip, B, cs, H, W, none, (const float*)w1s, nullptr, nullptr, 1,
       nullptr, (float*)ys, nullptr, st);
  conv(cout, (const bf16*)up, P, cu, H, W, none, (const float*)w1u, nullptr, (const float*)ys,
       P / B, (bf16*)c1, nullptr, (float*)part1, st);
  GNIn gn1{(const float*)part1, (const float*)g1w, (const float*)g1b, tiles, inv_out};
  conv(cout, (const bf16*)c1, P, cout, H, W, gn1, (const float*)w2, nullptr, nullptr, 1,
       (bf16*)c2, nullptr, (float*)part2, st);
  if (head_w != nullptr) {
    GNIn gn2{(const float*)part2, (const float*)g2w, (const float*)g2b, tiles, inv_out};
    conv(1, (const bf16*)c2, P, cout, H, W, gn2, (const float*)head_w, (const float*)head_b,
         nullptr, 1, (bf16*)out, nullptr, nullptr, st);
  }
  return (int)cudaGetLastError();
}
