// Head-split multi-head self-attention forward, and the backward of both
// attention routes, for Hopper (sm_90a).
//
// Replaces semivl_tpu/ops/flash_attention.py::_fwd_kernel and ::_bwd_kernel
// (the Pallas TPU kernels behind flash_mha's head-split route, taken for
// heads whose width is not 64 or whose count is odd): softmax(q k^T /
// sqrt(D)) v per head of D = 16, 32, 64 or 128, keys at or past valid_len
// masked to -1e30, and its gradient. The backward at D = 64 also replaces
// ::_packed_bwd_kernel: the packed forward (flash_attention.cu) writes the
// same row log-sum-exp, and at D = 64 the two TPU backwards compute one
// function (1/8 is exact in bf16, so dk from the scaled q equals dk from q
// scaled after the product).
//
// What bounds it on this card: 4 B H L^2 D flops on 8 B L C bytes of q, k,
// v and out, so L / 2 flops per byte: the tiny VLM's L = 17 and 21 are
// bound by bytes (and by launch latency), the encoder widths (L >= 1025)
// by the tensor cores, the forward's exponentials close behind (it takes
// two per score, one in each pass).
//
// Design against the TPU kernels. They split the heads out of the (B, L,
// C) arrays into (B*H, L, D) copies and kept a head's whole K/V in VMEM;
// here q, k and v are read in place as views of the one (B, L, 3C) in_proj
// output (row stride 3C, head h at column h*D), and K/V stream through
// shared memory in tiles (a head's K and V at L = 2602, D = 128 are 1.3
// MB, more than a block's 227 KB). Rows and keys past L are zero-filled on
// load; keys past valid_len are masked in the softmax.
//
// Forward: the two-pass instance of attention_fwd.cuh (TMA ring of
// 128-key tiles, wgmma, the softmax in registers). The TPU forward
// normalises p before casting it to bf16 for p v; so does this one: pass 1
// finds each row's max and sum of exp (online, float32) from q k^T alone,
// pass 2 forms p = exp(s - max) / sum, rounds it to bf16 and accumulates
// p v with no rescale. It rounds exactly where JAX does (q times the bf16
// scale, p, the output) at the cost of computing q k^T twice; the packed
// kernel (flash_attention.cu) rounds the unnormalised p instead. The
// forward also writes each row's log-sum-exp when autograd needs it.
//
// Backward: it takes p = exp(s - lse) from the forward's log-sum-exp (the
// TPU backward recomputed the full-row softmax), delta = rowsum(dO o),
// ds = p (dO v^T - delta), p and ds rounded to bf16 before their products
// as the TPU kernel does:
//   dv = p^T dO, dk = ds^T q / sqrt(D), dq = ds k / sqrt(D).
// Blocks run in no order, so two kernels split the backward without float
// atomics (repeated runs agree bit for bit): one block per (key tile, head,
// batch) loops over the q tiles and keeps dk/dv in WMMA accumulators, one
// block per (q tile, head, batch) loops over the key tiles for dq. Its
// 64-row tiles, loads and WMMA products are attention_common.cuh's.

#include "attention_common.cuh"
#include "attention_fwd.cuh"

using namespace attention;

namespace {

// Shared memory (bytes) of each kernel for head width D.
template <int D>
struct Smem {
  typedef Sizes<D> S;
  static constexpr int DKDV = 5 * S::TILE + 2 * S::P + 2 * S::SCORES + S::STATS;
  static constexpr int DQ = 4 * S::TILE + S::P + 2 * S::SCORES + S::STATS;
};

// delta[b][h][i] = sum_d dO[b][i][h*D+d] * o[b][i][h*D+d]; one warp a row.
template <int D>
__global__ void heads_delta_kernel(const bf16* __restrict__ g, const bf16* __restrict__ o,
                                   float* __restrict__ delta, int B, int L, int H,
                                   long long bstride, long long rstride) {
  const long long wid = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)B * H * L) return;
  const int i = wid % L, h = (wid / L) % H, b = wid / ((long long)L * H);
  const long long off = b * bstride + i * rstride + (long long)h * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += __bfloat162float(g[off + d]) * __bfloat162float(o[off + d]);
  s = warp_sum(s);
  if (lane == 0) delta[wid] = s;
}

template <int D>
__global__ void __launch_bounds__(NTHREAD)
heads_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int valid_len,
                      long long in_bstride, long long in_rstride, long long g_bstride,
                      long long g_rstride, long long d_bstride, long long d_rstride, float qscale,
                      float gscale) {
  typedef Sizes<D> S;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::TILE);
  bf16* sQs = reinterpret_cast<bf16*>(smem + 2 * S::TILE);   // q times the bf16 scale
  bf16* sQ = reinterpret_cast<bf16*>(smem + 3 * S::TILE);    // q as given
  bf16* sG = reinterpret_cast<bf16*>(smem + 4 * S::TILE);
  bf16* sP = reinterpret_cast<bf16*>(smem + 5 * S::TILE);
  bf16* sDS = reinterpret_cast<bf16*>(smem + 5 * S::TILE + S::P);
  float* sS = reinterpret_cast<float*>(smem + 5 * S::TILE + 2 * S::P);
  float* sDP = reinterpret_cast<float*>(smem + 5 * S::TILE + 2 * S::P + S::SCORES);
  float* sLse = reinterpret_cast<float*>(smem + 5 * S::TILE + 2 * S::P + 2 * S::SCORES);
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  const long long g_off = (long long)b * g_bstride + (long long)h * D;
  const float* lse_bh = lse + ((long long)b * H + h) * L;
  const float* delta_bh = delta + ((long long)b * H + h) * L;
  float* sSw = sS + warp * 16 * LDS;
  float* sDPw = sDP + warp * 16 * LDS;
  bf16* sPw = sP + warp * 16 * LDP;
  bf16* sDSw = sDS + warp * 16 * LDP;
  const int key0 = k0 + warp * 16;   // this warp's 16 keys

  load_rows<D>(sK, k + head_off, k0, L, in_rstride, 1.0f);
  load_rows<D>(sV, v + head_off, k0, L, in_rstride, 1.0f);
  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  const int n_tiles = (L + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous q tile is done with sQs / sQ / sG / sLse
    load_rows<D>(sQs, q + head_off, q0, L, in_rstride, qscale);
    load_rows<D>(sQ, q + head_off, q0, L, in_rstride, 1.0f);
    load_rows<D>(sG, g + g_off, q0, L, g_rstride, 1.0f);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < L ? lse_bh[row] : 0.f;
      sDelta[threadIdx.x] = row < L ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    // s^T = k q_s^T and dp^T = v dO^T for this warp's 16 keys x 64 q rows
    mm_abt<D>(sK + warp * 16 * LD, sQs, sSw);
    mm_abt<D>(sV + warp * 16 * LD, sG, sDPw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const bool key_ok = key0 + r < valid_len;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float p = 0.f, ds = 0.f;
        if (key_ok && q0 + c < L) {
          p = expf(sSw[r * LDS + c] - sLse[c]);
          ds = p * (sDPw[r * LDS + c] - sDelta[c]);
        }
        sPw[r * LDP + c] = __float2bfloat16(p);
        sDSw[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab_acc<D>(sPw, sG, acc_dv);    // dv += p^T dO
    mm_ab_acc<D>(sDSw, sQ, acc_dk);   // dk += ds^T q (scaled at the end)
  }
  const long long d_off = (long long)b * d_bstride + (long long)h * D;
  store_rows<D>(acc_dv, sSw, dv + d_off, key0, L, d_rstride, 1.0f, lane);
  store_rows<D>(acc_dk, sSw, dk + d_off, key0, L, d_rstride, gscale, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREAD)
heads_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int L, int valid_len, long long in_bstride,
                    long long in_rstride, long long g_bstride, long long g_rstride,
                    long long d_bstride, long long d_rstride, float qscale, float gscale) {
  typedef Sizes<D> S;
  constexpr int LD = S::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQs = reinterpret_cast<bf16*>(smem);
  bf16* sG = reinterpret_cast<bf16*>(smem + S::TILE);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * S::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * S::TILE);
  bf16* sDS = reinterpret_cast<bf16*>(smem + 4 * S::TILE);
  float* sS = reinterpret_cast<float*>(smem + 4 * S::TILE + S::P);
  float* sDP = reinterpret_cast<float*>(smem + 4 * S::TILE + S::P + S::SCORES);
  float* sLse = reinterpret_cast<float*>(smem + 4 * S::TILE + S::P + 2 * S::SCORES);
  float* sDelta = sLse + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  const long long g_off = (long long)b * g_bstride + (long long)h * D;
  float* sSw = sS + warp * 16 * LDS;
  float* sDPw = sDP + warp * 16 * LDS;
  bf16* sDSw = sDS + warp * 16 * LDP;
  const int row0 = q0 + warp * 16;   // this warp's 16 q rows

  load_rows<D>(sQs, q + head_off, q0, L, in_rstride, qscale);
  load_rows<D>(sG, g + g_off, q0, L, g_rstride, 1.0f);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const long long bh = ((long long)b * H + h) * L;
    sLse[threadIdx.x] = row < L ? lse[bh + row] : 0.f;
    sDelta[threadIdx.x] = row < L ? delta[bh + row] : 0.f;
  }
  FragC acc_dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc_dq[n], 0.f);

  // key tiles wholly past valid_len have p = 0: they add nothing
  const int n_tiles = (valid_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous key tile is done with sK / sV
    load_rows<D>(sK, k + head_off, k0, L, in_rstride, 1.0f);
    load_rows<D>(sV, v + head_off, k0, L, in_rstride, 1.0f);
    __syncthreads();

    mm_abt<D>(sQs + warp * 16 * LD, sK, sSw);
    mm_abt<D>(sG + warp * 16 * LD, sV, sDPw);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int wr = warp * 16 + r;
      const bool row_ok = row0 + r < L;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        float ds = 0.f;
        if (row_ok && k0 + c < valid_len) {
          const float p = expf(sSw[r * LDS + c] - sLse[wr]);
          ds = p * (sDPw[r * LDS + c] - sDelta[wr]);
        }
        sDSw[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    mm_ab_acc<D>(sDSw, sK, acc_dq);   // dq += ds k
  }
  store_rows<D>(acc_dq, sSw, dq + (long long)b * d_bstride + (long long)h * D, row0, L,
                d_rstride, gscale, lane);
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* g,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int L, int H,
               int valid_len, long long in_bstride, long long in_rstride, long long g_bstride,
               long long g_rstride, long long d_bstride, long long d_rstride, float qscale,
               float gscale, cudaStream_t st) {
  const long long rows = (long long)B * H * L;
  heads_delta_kernel<D><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, st>>>(
      (const bf16*)g, (const bf16*)o, (float*)delta, B, L, H, g_bstride, g_rstride);
  cudaFuncSetAttribute(heads_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Smem<D>::DKDV);
  cudaFuncSetAttribute(heads_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Smem<D>::DQ);
  dim3 grid_k((L + BK - 1) / BK, H, B), grid_q((L + BQ - 1) / BQ, H, B);
  heads_bwd_dkdv_kernel<D><<<grid_k, NTHREAD, Smem<D>::DKDV, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, L, valid_len, in_bstride, in_rstride,
      g_bstride, g_rstride, d_bstride, d_rstride, qscale, gscale);
  heads_bwd_dq_kernel<D><<<grid_q, NTHREAD, Smem<D>::DQ, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, (const float*)lse,
      (const float*)delta, (bf16*)dq, L, valid_len, in_bstride, in_rstride, g_bstride,
      g_rstride, d_bstride, d_rstride, qscale, gscale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, L, H*D) views sharing strides (batch, row) with unit
// column stride and 16-byte aligned rows, D in {16, 32, 64, 128}; out: bf16
// with its own strides; lse: null, or float32 (B, H, L) for each row's
// log-sum-exp of the scaled scores. qscale: 1/sqrt(D) as a bf16 value (q is
// multiplied by it and rounded to bf16 before q k^T). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another D).
extern "C" int heads_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int B, int L, int H, int D, int valid_len,
                                   long long in_bstride, long long in_rstride,
                                   long long out_bstride, long long out_rstride, float qscale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEMIVL_HEADS_FWD(N)                                                                  \
  case N:                                                                                    \
    return attention_fwd::launch<N, true>(q, k, v, out, lse, B, L, H, valid_len, in_bstride, \
                                          in_rstride, out_bstride, out_rstride, qscale, st);
  switch (D) {
    SEMIVL_HEADS_FWD(16)
    SEMIVL_HEADS_FWD(32)
    SEMIVL_HEADS_FWD(64)
    SEMIVL_HEADS_FWD(128)
  }
#undef SEMIVL_HEADS_FWD
  return (int)cudaErrorInvalidValue;
}

// Backward of heads_attention_fwd, and at D = 64 of packed_attention_fwd
// (flash_attention.cu). q, k, v: the forward's bf16 views (in_*
// strides); o: its output and g: bf16 dO, both with the g_* strides; lse:
// the forward's float32 (B, H, L) output; delta: float32 (B, H, L) scratch;
// dq, dk, dv: bf16 outputs sharing the d_* strides, e.g. the column thirds
// of one (B, L, 3C) buffer. qscale: as the forward's; gscale: 1/sqrt(D) in
// float32, the factor of dq and dk. Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for another D).
extern "C" int heads_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* g, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int L, int H, int D,
                                   int valid_len, long long in_bstride, long long in_rstride,
                                   long long g_bstride, long long g_rstride,
                                   long long d_bstride, long long d_rstride, float qscale,
                                   float gscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define SEMIVL_HEADS_BWD(N)                                                                   \
  case N:                                                                                     \
    return launch_bwd<N>(q, k, v, o, g, lse, delta, dq, dk, dv, B, L, H, valid_len,           \
                         in_bstride, in_rstride, g_bstride, g_rstride, d_bstride, d_rstride,  \
                         qscale, gscale, st);
  switch (D) {
    SEMIVL_HEADS_BWD(16)
    SEMIVL_HEADS_BWD(32)
    SEMIVL_HEADS_BWD(64)
    SEMIVL_HEADS_BWD(128)
  }
#undef SEMIVL_HEADS_BWD
  return (int)cudaErrorInvalidValue;
}
