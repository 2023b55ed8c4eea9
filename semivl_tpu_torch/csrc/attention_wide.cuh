// Head-split attention for head widths above 128, forward and backward, on
// the CUDA cores (sm_90a): the widths that attention_fwd.cuh and
// attention_bwd.cuh do not take (their wgmma products and register tiles
// end at D = 128). Part of the port of semivl_tpu/ops/flash_attention.py::
// _fwd_kernel and ::_bwd_kernel, which take any width (their blocks are
// (1, bq, D) with the whole D); flash_attention_heads.cu routes a width
// above 128 here. No model of the repository has such heads, so the design
// is the simple one, float32 on the CUDA cores, right before fast.
//
// What bounds it on this card: the same 4 B H L^2 D flops as the narrow
// kernels, here on the CUDA cores (67 TFLOP/s float32 at most, against 989
// on the tensor cores), and the forward's first pass and every column
// group recompute q k^T; so operations.
//
// Tiles of 64 query rows x 64 keys, 256 threads, each thread 4 x 4 scores
// (rows ty + 16 i, keys tx + 16 j). A score tile is a loop over the full
// D in 64-column chunks staged in shared memory as float32. Outputs are
// split into groups of at most 128 columns (grid z); each group's block
// recomputes the scores over the full D.
//  - Forward (fwd_kernel): pass 1 takes each row's max and sum of exp
//    (online, float32) over the key tiles up to valid_len, pass 2 forms p =
//    exp(s - max) / sum, rounds it to bf16 and accumulates p v for the
//    block's columns in float32; q is multiplied by the bf16 scale and
//    rounded to bf16 first. JAX's _fwd_kernel rounds at the same points
//    (q times the scale, the normalised p, the output). The group-0 block
//    writes lse = max + log(sum).
//  - Backward: prep_kernel takes delta = rowsum(dO o) over the full D;
//    dkdv_kernel (a block per key tile and column group) and dq_kernel (a
//    block per query tile and column group) recompute s = qs k^T and dp =
//    dO v^T over the full D, p = exp(s - lse), ds = p (dp - delta), round p
//    and ds to bf16 and accumulate dv = p^T dO, dk = ds^T q, dq = ds k in
//    float32, scaled by 1/sqrt(D) in float32 after the products, as
//    attention_bwd.cuh does. Keys at or past valid_len get p = 0 (their dk
//    and dv are written as zeros). No float atomics: reruns agree bit for
//    bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wide_attention {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;        // query rows and keys of a tile; D columns of a chunk
constexpr int SP = T + 1;    // padded row of a staged 64 x 64 chunk
constexpr int NG = 128;      // output columns of a group
constexpr int NTH = 256;
constexpr int CHUNK = T * SP;   // floats of a staged chunk

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

// dst[r][c] (row pitch `pitch` floats) = src[row0 + r][c0 + c] for r < 64,
// c < `cols` (a multiple of 8), zero past `nrows` rows or D columns; with
// scale > 0 each value times scale, rounded to bf16. src: bf16 rows at
// `rstride` elements, 16-byte aligned at every 8th column.
__device__ __forceinline__ void stage(float* dst, int pitch, int cols, const bf16* src,
                                      long long rstride, int row0, int nrows, int c0, int D,
                                      float scale) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < T * per_row; i += NTH) {
    const int r = i / per_row, c = (i % per_row) * 8;
    float v[8];
    if (row0 + r < nrows && c0 + c < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (row0 + r) * rstride + c0 + c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = __bfloat162float(e[j]);
        if (scale > 0.f) v[j] = bf16r(v[j] * scale);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * pitch + c + j] = v[j];
  }
}

// acc[i][j] += sum over the full D of a[row0 + ty + 16 i][:] b[col0 + tx +
// 16 j][:], staging 64-column chunks of both in sa, sb (a scaled by `scale`
// as stage() does). Ends with the last chunk still staged.
__device__ __forceinline__ void scores(float (&acc)[4][4], float* sa, float* sb, const bf16* a,
                                       const bf16* b, long long rstride, int row0, int col0,
                                       int L, int D, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c0 = 0; c0 < D; c0 += T) {
    __syncthreads();
    stage(sa, SP, T, a, rstride, row0, L, c0, D, scale);
    stage(sb, SP, T, b, rstride, col0, L, c0, D, 0.f);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < T; ++k) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sa[(ty + 16 * i) * SP + k];
        y[i] = sb[(tx + 16 * i) * SP + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
    }
  }
}

// Per (query tile, batch x head, column group): the forward of the head's
// rows q0 .. q0 + 63 for output columns g0 .. g0 + 127.
__global__ void __launch_bounds__(NTH)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ out, float* __restrict__ lse, int L, int H, int D, int valid_len,
           long long in_bstride, long long in_rstride, long long out_bstride,
           long long out_rstride, float qscale) {
  extern __shared__ float sm[];
  float *sq = sm, *sk = sq + CHUNK, *sp = sk + CHUNK, *sv = sp + CHUNK;
  float* s_m = sv + T * NG;
  float* s_l = s_m + T;
  const int q0 = blockIdx.x * T, b = blockIdx.y / H, h = blockIdx.y % H, g0 = blockIdx.z * NG;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long head = (long long)b * in_bstride + (long long)h * D;
  const bf16 *qh = q + head, *kh = k + head, *vh = v + head;
  const int ntiles = (valid_len + T - 1) / T;
  float m = -INFINITY, l = 0.f;   // row threadIdx.x < 64

  for (int pass = 0; pass < 2; ++pass) {
    float o[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    for (int kt = 0; kt < ntiles; ++kt) {
      const int k0 = kt * T;
      float s[4][4] = {};
      scores(s, sq, sk, qh, kh, in_rstride, q0, k0, L, D, qscale);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sp[(ty + 16 * i) * SP + tx + 16 * j] = k0 + tx + 16 * j < valid_len ? s[i][j] : -1e30f;
      __syncthreads();
      if (pass == 0) {
        if (threadIdx.x < T) {
          const float* row = sp + threadIdx.x * SP;
          float mx = m;
          for (int c = 0; c < T; ++c) mx = fmaxf(mx, row[c]);
          float sum = 0.f;
          for (int c = 0; c < T; ++c) sum += expf(row[c] - mx);
          l = l * expf(m - mx) + sum;   // 0 on the first tile
          m = mx;
        }
        continue;
      }
      // pass 2: p = exp(s - m) / l rounded to bf16, then p v
      if (threadIdx.x < T) {
        float* row = sp + threadIdx.x * SP;
        for (int c = 0; c < T; ++c) row[c] = bf16r(expf(row[c] - s_m[threadIdx.x]) / s_l[threadIdx.x]);
      }
      stage(sv, NG, NG, vh, in_rstride, k0, L, g0, D, 0.f);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < T; ++c) {
        float pv[4], vv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sp[(ty + 16 * i) * SP + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) vv[j] = sv[c * NG + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) o[i][j] += pv[i] * vv[j];
      }
    }
    if (pass == 0) {
      if (threadIdx.x < T) {
        s_m[threadIdx.x] = m;
        s_l[threadIdx.x] = l;
        const int row = q0 + threadIdx.x;
        if (lse != nullptr && blockIdx.z == 0 && row < L)
          lse[((long long)b * H + h) * L + row] = m + logf(l);
      }
      __syncthreads();
      continue;
    }
    bf16* oh = out + (long long)b * out_bstride + (long long)h * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = g0 + tx + 16 * j;
        if (row < L && col < D && tx + 16 * j < NG)
          oh[row * out_rstride + col] = __float2bfloat16(o[i][j]);
      }
    }
  }
}

// delta[b][h][i] = sum_d dO[b][i][h D + d] o[b][i][h D + d] (float32 sums of
// the bf16 values).
__global__ void __launch_bounds__(NTH)
prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ g, float* __restrict__ delta,
            int L, int H, int D, long long g_bstride, long long g_rstride) {
  const int i = blockIdx.x * NTH + threadIdx.x, b = blockIdx.y / H, h = blockIdx.y % H;
  if (i >= L) return;
  const long long at = (long long)b * g_bstride + i * g_rstride + (long long)h * D;
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += __bfloat162float(o[at + d]) * __bfloat162float(g[at + d]);
  delta[((long long)b * H + h) * L + i] = s;
}

struct BwdArgs {
  const bf16 *q, *k, *v, *g;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int L, H, D, valid_len;
  long long in_bstride, in_rstride, g_bstride, g_rstride, d_bstride, d_rstride;
  float qscale, gscale;
};

// p (rounded to bf16 in sp, with `keep_p`) and ds (rounded, in sds) of the
// tile of query rows q0 and keys k0: s = qs k^T and dp = dO v^T over the
// full D, staged through sa .. sd.
__device__ __forceinline__ void p_ds(const BwdArgs& a, long long head, long long ghead, int q0,
                                     int k0, float* sa, float* sb, float* sc, float* sd,
                                     float* sp, float* sds, const float* s_lse,
                                     const float* s_del) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
  scores(s, sa, sb, a.q + head, a.k + head, a.in_rstride, q0, k0, a.L, a.D, a.qscale);
  // dO and v have their own strides: one chunk loop each
  const int L = a.L, D = a.D;
  for (int c0 = 0; c0 < D; c0 += T) {
    __syncthreads();
    stage(sc, SP, T, a.g + ghead, a.g_rstride, q0, L, c0, D, 0.f);
    stage(sd, SP, T, a.v + head, a.in_rstride, k0, L, c0, D, 0.f);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = sc[(ty + 16 * i) * SP + kk];
        y[i] = sd[(tx + 16 * i) * SP + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] += x[i] * y[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = k0 + c < a.valid_len ? expf(s[i][j] - s_lse[r]) : 0.f;
      if (sp != nullptr) sp[r * SP + c] = bf16r(p);
      sds[r * SP + c] = bf16r(p * (dp[i][j] - s_del[r]));
    }
  }
  __syncthreads();
}

// Per (key tile, batch x head, column group): dk and dv of keys k0 .. k0 +
// 63 for columns g0 .. g0 + 127.
__global__ void __launch_bounds__(NTH) dkdv_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  float *sa = sm, *sb = sa + CHUNK, *sc = sb + CHUNK, *sd = sc + CHUNK;
  float *sp = sd + CHUNK, *sds = sp + CHUNK, *s_lse = sds + CHUNK, *s_del = s_lse + T;
  float *sg = sa, *sq = sa + T * NG;   // the group's dO and q rows, over sa .. sd
  const int k0 = blockIdx.x * T, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int g0 = blockIdx.z * NG, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long head = (long long)b * a.in_bstride + (long long)h * a.D;
  const long long ghead = (long long)b * a.g_bstride + (long long)h * a.D;
  const long long bh = ((long long)b * a.H + h) * a.L;
  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int q0 = 0; k0 < a.valid_len && q0 < a.L; q0 += T) {
    __syncthreads();
    if (threadIdx.x < T) {
      const int row = q0 + threadIdx.x;
      s_lse[threadIdx.x] = row < a.L ? a.lse[bh + row] : INFINITY;   // p = 0 past L
      s_del[threadIdx.x] = row < a.L ? a.delta[bh + row] : 0.f;
    }
    p_ds(a, head, ghead, q0, k0, sa, sb, sc, sd, sp, sds, s_lse, s_del);
    stage(sg, NG, NG, a.g + ghead, a.g_rstride, q0, a.L, g0, a.D, 0.f);
    stage(sq, NG, NG, a.q + head, a.in_rstride, q0, a.L, g0, a.D, 0.f);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < T; ++r) {
      float pv[4], dsv[4], gv[8], qv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sp[r * SP + ty + 16 * i];
        dsv[i] = sds[r * SP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        gv[j] = sg[r * NG + tx + 16 * j];
        qv[j] = sq[r * NG + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv[i][j] += pv[i] * gv[j];
          dk[i][j] += dsv[i] * qv[j];
        }
    }
  }
  const long long dhead = (long long)b * a.d_bstride + (long long)h * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g0 + tx + 16 * j;
      if (key < a.L && col < a.D) {
        a.dk[dhead + key * a.d_rstride + col] = __float2bfloat16(dk[i][j] * a.gscale);
        a.dv[dhead + key * a.d_rstride + col] = __float2bfloat16(dv[i][j]);
      }
    }
  }
}

// Per (query tile, batch x head, column group): dq of rows q0 .. q0 + 63
// for columns g0 .. g0 + 127.
__global__ void __launch_bounds__(NTH) dq_kernel(const BwdArgs a) {
  extern __shared__ float sm[];
  float *sa = sm, *sb = sa + CHUNK, *sc = sb + CHUNK, *sd = sc + CHUNK;
  float *sds = sd + CHUNK, *s_lse = sds + CHUNK, *s_del = s_lse + T;
  float* sk = sa;   // the group's k rows, over sa .. sd
  const int q0 = blockIdx.x * T, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int g0 = blockIdx.z * NG, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long head = (long long)b * a.in_bstride + (long long)h * a.D;
  const long long ghead = (long long)b * a.g_bstride + (long long)h * a.D;
  const long long bh = ((long long)b * a.H + h) * a.L;
  if (threadIdx.x < T) {
    const int row = q0 + threadIdx.x;
    s_lse[threadIdx.x] = row < a.L ? a.lse[bh + row] : INFINITY;
    s_del[threadIdx.x] = row < a.L ? a.delta[bh + row] : 0.f;
  }
  float dq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dq[i][j] = 0.f;
  for (int k0 = 0; k0 < a.valid_len; k0 += T) {
    p_ds(a, head, ghead, q0, k0, sa, sb, sc, sd, nullptr, sds, s_lse, s_del);
    stage(sk, NG, NG, a.k + head, a.in_rstride, k0, a.L, g0, a.D, 0.f);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < T; ++c) {
      float dsv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sk[c * NG + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dq[i][j] += dsv[i] * kv[j];
    }
    __syncthreads();
  }
  const long long dhead = (long long)b * a.d_bstride + (long long)h * a.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = g0 + tx + 16 * j;
      if (row < a.L && col < a.D)
        a.dq[dhead + row * a.d_rstride + col] = __float2bfloat16(dq[i][j] * a.gscale);
    }
  }
}

constexpr int FWD_SMEM = (3 * CHUNK + T * NG + 2 * T) * 4;
constexpr int DKDV_SMEM = (6 * CHUNK + 2 * T) * 4;
constexpr int DQ_SMEM = (5 * CHUNK + 2 * T) * 4;

inline int groups(int D) { return (D + NG - 1) / NG; }

// D: a multiple of 16 above 128 (the narrow widths have their own
// kernels). Arguments as heads_attention_fwd's. Returns a CUDA error code.
inline int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                      int L, int H, int D, int valid_len, long long in_bstride,
                      long long in_rstride, long long out_bstride, long long out_rstride,
                      float qscale, cudaStream_t st) {
  if (D <= 128 || D % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + T - 1) / T, B * H, groups(D));
  fwd_kernel<<<grid, NTH, FWD_SMEM, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                          (bf16*)out, (float*)lse, L, H, D, valid_len,
                                          in_bstride, in_rstride, out_bstride, out_rstride,
                                          qscale);
  return (int)cudaGetLastError();
}

// Arguments as heads_attention_bwd's. Returns a CUDA error code.
inline int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
                      const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int L,
                      int H, int D, int valid_len, long long in_bstride, long long in_rstride,
                      long long g_bstride, long long g_rstride, long long d_bstride,
                      long long d_rstride, float qscale, float gscale, cudaStream_t st) {
  if (D <= 128 || D % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  prep_kernel<<<dim3((L + NTH - 1) / NTH, B * H), NTH, 0, st>>>(
      (const bf16*)o, (const bf16*)g, (float*)delta, L, H, D, g_bstride, g_rstride);
  const BwdArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g,
                  (const float*)lse, (const float*)delta, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                  L, H, D, valid_len, in_bstride, in_rstride, g_bstride, g_rstride,
                  d_bstride, d_rstride, qscale, gscale};
  const dim3 grid((L + T - 1) / T, B * H, groups(D));
  dkdv_kernel<<<grid, NTH, DKDV_SMEM, st>>>(a);
  dq_kernel<<<grid, NTH, DQ_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wide_attention
