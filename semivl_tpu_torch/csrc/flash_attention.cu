// Packed multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces semivl_tpu/ops/flash_attention.py::_packed_fwd_kernel (the
// Pallas TPU kernel behind flash_mha's packed path): softmax(q k^T / 8) v
// per head of 64, read straight from the (B, L, C) rows so no head
// transposes are materialised, float32 softmax, keys at or past valid_len
// masked to -1e30.
//
// What bounds it on this card: at the encoder shape (B=2, L=1025, 12 heads)
// it does 4*B*H*L^2*64 = 6.5 GFLOP on 9.4 MB of q/k/v/out, about 690 flops
// per byte, so it is bound by the tensor cores, not by memory. The TPU
// kernel kept every key of a head resident (VMEM holds megabytes); here one
// head's K and V at L=1025 are 2 x 131 KB, more than a block's 227 KB of
// shared memory, so K/V are streamed in 64-key tiles with an online
// (running max / running sum) softmax in float32, and the products run on
// the tensor cores through WMMA bf16 16x16x16 fragments with float32
// accumulation. Speed work (wgmma, TMA, warp specialisation) is later work.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 q rows. q, k and v are views of one in_proj output: the
// row stride (3C there) and batch stride are arguments, nothing is copied.
// Rows and keys past L (L=1025 and L=21 are ragged against any tile) are
// zero-filled on load and masked in the softmax. q is scaled by 1/8 in
// bf16 before q k^T, as the TPU kernel does.
//
// Numerics against the TPU kernel: it normalises p before casting it to
// bf16 for p v; here the unnormalised p (in (0, 1]) is cast and the sum is
// divided out at the end in float32. Both round p once to bf16, so the
// two differ by about one bf16 ulp of the output (2^-8 relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;            // head dim
constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NWARP = BQ / 16;   // 4 warps, 16 q rows each
constexpr int NTHREAD = NWARP * 32;
constexpr int LDH = D + 8;       // bf16 row pitch (72: 144 B, 16 B aligned)
constexpr int LDF = BK + 4;      // fp32 row pitch of S and O (68)

constexpr int SZ_Q = BQ * LDH * 2;
constexpr int SZ_K = BK * LDH * 2;
constexpr int SZ_P = NWARP * 16 * LDH * 2;
constexpr int SZ_S = NWARP * 16 * LDF * 4;
constexpr int SMEM = SZ_Q + 2 * SZ_K + SZ_P + 2 * SZ_S + 2 * BQ * 4;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [r0, r0 + 64) of one head (64 bf16 = 8 x 16 B) into a pitched
// shared tile; rows at or past L are zeros. With `scale` != 1 each value is
// multiplied and rounded back to bf16.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int L,
                                          long long row_stride, float scale) {
  for (int c = threadIdx.x; c < 64 * 8; c += NTHREAD) {
    int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
      if (scale != 1.0f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

__global__ void __launch_bounds__(NTHREAD)
packed_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int L, int valid_len,
                            long long in_bstride, long long in_rstride,
                            long long out_bstride, long long out_rstride, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + SZ_Q);
  bf16* sV = reinterpret_cast<bf16*>(smem + SZ_Q + SZ_K);
  bf16* sP = reinterpret_cast<bf16*>(smem + SZ_Q + 2 * SZ_K);
  float* sS = reinterpret_cast<float*>(smem + SZ_Q + 2 * SZ_K + SZ_P);
  float* sO = sS + NWARP * 16 * LDF;
  float* sM = sO + NWARP * 16 * LDF;
  float* sL = sM + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  bf16* sPw = sP + warp * 16 * LDH;
  float* sSw = sS + warp * 16 * LDF;
  float* sOw = sO + warp * 16 * LDF;

  load_tile(sQ, q + head_off, q0, L, in_rstride, scale);
  for (int i = threadIdx.x; i < NWARP * 16 * LDF; i += NTHREAD) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = __int_as_float(0xff800000);  // -inf
    sL[threadIdx.x] = 0.f;
  }

  // Tiles wholly past valid_len add exactly 0 (their p underflows to 0).
  const int n_tiles = (valid_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's p v is done with sK / sV
    load_tile(sK, k + head_off, k0, L, in_rstride, 1.0f);
    load_tile(sV, v + head_off, k0, L, in_rstride, 1.0f);
    __syncthreads();

    // S = q k^T for this warp's 16 rows: 4 column fragments of 16 keys.
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(fb, sK + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sSw + n * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; lane owns columns lane, lane + 32.
    for (int r = 0; r < 16; ++r) {
      float s0 = sSw[r * LDF + lane], s1 = sSw[r * LDF + lane + 32];
      if (k0 + lane >= valid_len) s0 = -1e30f;
      if (k0 + lane + 32 >= valid_len) s1 = -1e30f;
      const float m_old = sM[warp * 16 + r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);  // 0 on the first tile
      sPw[r * LDH + lane] = __float2bfloat16(p0);
      sPw[r * LDH + lane + 32] = __float2bfloat16(p1);
      sOw[r * LDF + lane] *= corr;
      sOw[r * LDF + lane + 32] *= corr;
      if (lane == 0) {
        sM[warp * 16 + r] = m_new;
        sL[warp * 16 + r] = sL[warp * 16 + r] * corr + psum;
      }
    }
    __syncwarp();

    // O += p v, accumulated through shared memory (the per-row rescale
    // above needs row access that WMMA fragments do not give).
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sOw + n * 16, LDF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sPw + kk * 16, LDH);
        wmma::load_matrix_sync(fb, sV + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sOw + n * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= L) break;
    const float inv = 1.f / sL[warp * 16 + r];
    bf16* o = out + (long long)b * out_bstride + (long long)row * out_rstride + h * D;
    o[lane] = __float2bfloat16(sOw[r * LDF + lane] * inv);
    o[lane + 32] = __float2bfloat16(sOw[r * LDF + lane + 32] * inv);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * gridDim.y + h) * L + row] = sM[warp * 16 + r] + logf(sL[warp * 16 + r]);
  }
}


// ---------------------------------------------------------------- backward
//
// Replaces semivl_tpu/ops/flash_attention.py::_packed_bwd_kernel. With
// p = exp(s - lse) rebuilt from the forward's row log-sum-exp,
// delta = rowsum(dO o), ds = p (dO v^T - delta):
//   dv = p^T dO, dk = ds^T q / 8, dq = ds k / 8,
// p and ds rounded to bf16 before their products as the TPU kernel does.
// The TPU kernel held a head's whole K/V in VMEM and accumulated dk/dv
// across a sequential grid; here blocks run in no order, so two kernels
// split the work without float atomics (repeated runs agree bit for bit):
// one block per (key tile, head, batch) loops over the q tiles and keeps
// its dk/dv in WMMA accumulators, one block per (q tile, head, batch)
// loops over the key tiles for dq. Rows past L are zero-filled on load and
// their p and ds set to 0 (the TPU kernel's ragged-tail masking). At the
// encoder shape the backward does 2.5x the forward's products (s, dp, dv,
// dk, dq), bound by the tensor cores like the forward. The row statistics
// come from the forward (4 bytes a row, written only under autograd)
// rather than from a first backward pass over all keys: that pass would
// redo q k^T once more for every q tile, a fifth of the backward's work.

constexpr int SZ_T = 64 * LDH * 2;                 // one bf16 64-row tile
constexpr int SZ_W = NWARP * 16 * LDF * 4;         // per-warp fp32 16 x 64
constexpr int SZ_WH = NWARP * 16 * LDH * 2;        // per-warp bf16 16 x 64
constexpr int SMEM_DKDV = 4 * SZ_T + 2 * SZ_W + 2 * SZ_WH + 2 * BQ * 4;
constexpr int SMEM_DQ = 4 * SZ_T + 2 * SZ_W + SZ_WH + 2 * BQ * 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

// delta[b][h][i] = sum_d dO[b][i][h*64+d] * o[b][i][h*64+d]; one warp a row.
__global__ void attention_bwd_delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                                           float* __restrict__ delta, int B, int L, int H,
                                           long long bstride, long long rstride) {
  const long long wid = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)B * H * L) return;
  const int i = wid % L, h = (wid / L) % H, b = wid / ((long long)L * H);
  const long long off = b * bstride + i * rstride + h * D;
  float s = __bfloat162float(g[off + lane]) * __bfloat162float(o[off + lane]) +
            __bfloat162float(g[off + lane + 32]) * __bfloat162float(o[off + lane + 32]);
  s = warp_sum(s);
  if (lane == 0) delta[wid] = s;
}

// 16 x 64 = A (16 x 64, row-major, pitch LDH) times B^T, B given as 64 rows
// of 64 (pitch LDH): out[r][n] = sum_d A[r][d] B[n][d], stored fp32 (LDF).
__device__ __forceinline__ void mm_abt(const bf16* a, const bf16* bm, float* out) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, bm + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDF, wmma::mem_row_major);
  }
}

// acc[n] += A (16 x 64, pitch LDH) times B (64 x 64 row-major, pitch LDH).
__device__ __forceinline__ void mm_ab_acc(const bf16* a, const bf16* bm, FragC* acc) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, bm + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write a warp's 16 x 64 accumulator rows [row0, row0 + 16) (rows >= L
// skipped) as bf16, times `mul`, through the fp32 staging area `st`.
__device__ __forceinline__ void store_rows(FragC* acc, float* st, bf16* dst, int row0, int L,
                                           long long rstride, float mul, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::store_matrix_sync(st + n * 16, acc[n], LDF, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16 && row0 + r < L; ++r) {
    bf16* o = dst + (long long)(row0 + r) * rstride;
    o[lane] = __float2bfloat16(st[r * LDF + lane] * mul);
    o[lane + 32] = __float2bfloat16(st[r * LDF + lane + 32] * mul);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NTHREAD)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int valid_len,
                          long long in_bstride, long long in_rstride, long long g_bstride,
                          long long g_rstride, long long d_bstride, long long d_rstride,
                          float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + SZ_T);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * SZ_T);
  bf16* sG = reinterpret_cast<bf16*>(smem + 3 * SZ_T);
  float* sS = reinterpret_cast<float*>(smem + 4 * SZ_T);
  float* sDP = reinterpret_cast<float*>(smem + 4 * SZ_T + SZ_W);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * SZ_T + 2 * SZ_W);
  bf16* sDS = reinterpret_cast<bf16*>(smem + 4 * SZ_T + 2 * SZ_W + SZ_WH);
  float* sLse = reinterpret_cast<float*>(smem + 4 * SZ_T + 2 * SZ_W + 2 * SZ_WH);
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  const long long g_off = (long long)b * g_bstride + (long long)h * D;
  const float* lse_bh = lse + ((long long)b * H + h) * L;
  const float* delta_bh = delta + ((long long)b * H + h) * L;
  float* sSw = sS + warp * 16 * LDF;
  float* sDPw = sDP + warp * 16 * LDF;
  bf16* sPw = sP + warp * 16 * LDH;
  bf16* sDSw = sDS + warp * 16 * LDH;
  const int key0 = k0 + warp * 16;   // this warp's 16 keys

  load_tile(sK, k + head_off, k0, L, in_rstride, 1.0f);
  load_tile(sV, v + head_off, k0, L, in_rstride, 1.0f);
  FragC acc_dk[4], acc_dv[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  const int n_tiles = (L + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous q tile is done with sQ / sG / sLse
    load_tile(sQ, q + head_off, q0, L, in_rstride, scale);
    load_tile(sG, g + g_off, q0, L, g_rstride, 1.0f);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < L ? lse_bh[row] : 0.f;
      sDelta[threadIdx.x] = row < L ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    // s^T = k q_s^T and dp^T = v dO^T for this warp's 16 keys x 64 q rows
    mm_abt(sK + warp * 16 * LDH, sQ, sSw);
    mm_abt(sV + warp * 16 * LDH, sG, sDPw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const bool key_ok = key0 + r < valid_len;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f, ds = 0.f;
        if (key_ok && q0 + c < L) {
          p = expf(sSw[r * LDF + c] - sLse[c]);
          ds = p * (sDPw[r * LDF + c] - sDelta[c]);
        }
        sPw[r * LDH + c] = __float2bfloat16(p);
        sDSw[r * LDH + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    // dv += p^T dO, dk += ds^T q_s (q_s carries the 1/8)
    mm_ab_acc(sPw, sG, acc_dv);
    mm_ab_acc(sDSw, sQ, acc_dk);
  }
  const long long d_off = (long long)b * d_bstride + (long long)h * D;
  store_rows(acc_dv, sSw, dv + d_off, key0, L, d_rstride, 1.0f, lane);
  store_rows(acc_dk, sSw, dk + d_off, key0, L, d_rstride, 1.0f, lane);
}

__global__ void __launch_bounds__(NTHREAD)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int L, int valid_len, long long in_bstride,
                        long long in_rstride, long long g_bstride, long long g_rstride,
                        long long d_bstride, long long d_rstride, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = reinterpret_cast<bf16*>(smem + SZ_T);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * SZ_T);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * SZ_T);
  float* sS = reinterpret_cast<float*>(smem + 4 * SZ_T);
  float* sDP = reinterpret_cast<float*>(smem + 4 * SZ_T + SZ_W);
  bf16* sDS = reinterpret_cast<bf16*>(smem + 4 * SZ_T + 2 * SZ_W);
  float* sLse = reinterpret_cast<float*>(smem + 4 * SZ_T + 2 * SZ_W + SZ_WH);
  float* sDelta = sLse + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  const long long g_off = (long long)b * g_bstride + (long long)h * D;
  float* sSw = sS + warp * 16 * LDF;
  float* sDPw = sDP + warp * 16 * LDF;
  bf16* sDSw = sDS + warp * 16 * LDH;
  const int row0 = q0 + warp * 16;   // this warp's 16 q rows

  load_tile(sQ, q + head_off, q0, L, in_rstride, scale);
  load_tile(sG, g + g_off, q0, L, g_rstride, 1.0f);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const long long bh = ((long long)b * H + h) * L;
    sLse[threadIdx.x] = row < L ? lse[bh + row] : 0.f;
    sDelta[threadIdx.x] = row < L ? delta[bh + row] : 0.f;
  }
  FragC acc_dq[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc_dq[n], 0.f);

  // key tiles wholly past valid_len have p = 0: they add nothing
  const int n_tiles = (valid_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous key tile is done with sK / sV
    load_tile(sK, k + head_off, k0, L, in_rstride, 1.0f);
    load_tile(sV, v + head_off, k0, L, in_rstride, 1.0f);
    __syncthreads();

    mm_abt(sQ + warp * 16 * LDH, sK, sSw);
    mm_abt(sG + warp * 16 * LDH, sV, sDPw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int wr = warp * 16 + r;
      const bool row_ok = row0 + r < L;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float ds = 0.f;
        if (row_ok && k0 + c < valid_len) {
          const float p = expf(sSw[r * LDF + c] - sLse[wr]);
          ds = p * (sDPw[r * LDF + c] - sDelta[wr]);
        }
        sDSw[r * LDH + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab_acc(sDSw, sK, acc_dq);   // dq += ds k
  }
  store_rows(acc_dq, sSw, dq + (long long)b * d_bstride + (long long)h * D, row0, L, d_rstride,
             scale, lane);
}

}  // namespace

// q, k, v: bf16 (B, L, H*64) views sharing strides (batch, row) with unit
// column stride and 16-byte aligned rows; out: bf16 with its own strides;
// lse: null, or float32 (B, H, L) for each row's log-sum-exp of the scaled
// scores (what the backward needs to rebuild the probabilities).
// Returns cudaGetLastError() after the launch.
extern "C" int packed_attention_fwd(const void* q, const void* k, const void* v,
                                    void* out, void* lse, int B, int L, int H,
                                    int valid_len, long long in_bstride,
                                    long long in_rstride, long long out_bstride,
                                    long long out_rstride, float scale, void* stream) {
  cudaFuncSetAttribute(packed_attention_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  dim3 grid((L + BQ - 1) / BQ, H, B);
  packed_attention_fwd_kernel<<<grid, NTHREAD, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, L,
      valid_len, in_bstride, in_rstride, out_bstride, out_rstride, scale);
  return (int)cudaGetLastError();
}

// Backward of packed_attention_fwd. q, k, v: the forward's bf16 views
// (in_* strides); g: bf16 dO with (g_*) strides; lse: the forward's float32
// (B, H, L) output; delta: float32 (B, H, L) scratch; dq, dk, dv: bf16
// outputs sharing (d_*) strides, e.g. the column thirds of one (B, L, 3C)
// buffer. o: the forward's output with the same strides as g. Returns
// cudaGetLastError() after the launches.
extern "C" int packed_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* g, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv, int B, int L,
                                    int H, int valid_len, long long in_bstride,
                                    long long in_rstride, long long g_bstride,
                                    long long g_rstride, long long d_bstride,
                                    long long d_rstride, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * H * L;
  attention_bwd_delta_kernel<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(
      (const bf16*)g, (const bf16*)o, (float*)delta, B, L, H, g_bstride, g_rstride);
  cudaFuncSetAttribute(attention_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_DKDV);
  cudaFuncSetAttribute(attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_DQ);
  dim3 grid_k((L + BK - 1) / BK, H, B), grid_q((L + BQ - 1) / BQ, H, B);
  attention_bwd_dkdv_kernel<<<grid_k, NTHREAD, SMEM_DKDV, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, L, valid_len, in_bstride, in_rstride,
      g_bstride, g_rstride, d_bstride, d_rstride, scale);
  attention_bwd_dq_kernel<<<grid_q, NTHREAD, SMEM_DQ, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)delta, (bf16*)dq, L, valid_len, in_bstride, in_rstride, g_bstride,
      g_rstride, d_bstride, d_rstride, scale);
  return (int)cudaGetLastError();
}
