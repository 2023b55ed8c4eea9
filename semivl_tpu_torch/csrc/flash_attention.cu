// Packed multi-head self-attention forward for Hopper (sm_90a). Its
// backward is heads_attention_bwd at D = 64 (flash_attention_heads.cu),
// from the row log-sum-exp this kernel writes under autograd.
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
// two differ by about one bf16 ulp of the output (2^-8 relative). The
// tiles, loads and WMMA products are attention_common.cuh's.

#include "attention_common.cuh"

using namespace attention;

namespace {

constexpr int D = 64;   // head dim
typedef Sizes<D> S;
constexpr int SMEM = 3 * S::TILE + S::P + 2 * S::SCORES + S::STATS;

__global__ void __launch_bounds__(NTHREAD)
packed_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int L, int valid_len,
                            long long in_bstride, long long in_rstride,
                            long long out_bstride, long long out_rstride, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + S::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * S::TILE);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * S::TILE);
  float* sS = reinterpret_cast<float*>(smem + 3 * S::TILE + S::P);
  float* sO = sS + NWARP * 16 * LDS;
  float* sM = sO + NWARP * 16 * LDS;
  float* sL = sM + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head_off = (long long)b * in_bstride + (long long)h * D;
  bf16* sPw = sP + warp * 16 * LDP;
  float* sSw = sS + warp * 16 * LDS;
  float* sOw = sO + warp * 16 * LDS;

  load_rows<D>(sQ, q + head_off, q0, L, in_rstride, scale);
  for (int i = threadIdx.x; i < NWARP * 16 * LDS; i += NTHREAD) sO[i] = 0.f;
  if (threadIdx.x < BQ) {
    sM[threadIdx.x] = __int_as_float(0xff800000);  // -inf
    sL[threadIdx.x] = 0.f;
  }

  // Tiles wholly past valid_len add exactly 0 (their p underflows to 0).
  const int n_tiles = (valid_len + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's p v is done with sK / sV
    load_rows<D>(sK, k + head_off, k0, L, in_rstride, 1.0f);
    load_rows<D>(sV, v + head_off, k0, L, in_rstride, 1.0f);
    __syncthreads();

    // S = q k^T for this warp's 16 rows: 4 column fragments of 16 keys.
    mm_abt<D>(sQ + warp * 16 * S::LD, sK, sSw);
    __syncwarp();

    // Online softmax, one row at a time; lane owns columns lane, lane + 32.
    for (int r = 0; r < 16; ++r) {
      float s0 = sSw[r * LDS + lane], s1 = sSw[r * LDS + lane + 32];
      if (k0 + lane >= valid_len) s0 = -1e30f;
      if (k0 + lane + 32 >= valid_len) s1 = -1e30f;
      const float m_old = sM[warp * 16 + r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);  // 0 on the first tile
      sPw[r * LDP + lane] = __float2bfloat16(p0);
      sPw[r * LDP + lane + 32] = __float2bfloat16(p1);
      sOw[r * LDS + lane] *= corr;
      sOw[r * LDS + lane + 32] *= corr;
      if (lane == 0) {
        sM[warp * 16 + r] = m_new;
        sL[warp * 16 + r] = sL[warp * 16 + r] * corr + psum;
      }
    }
    __syncwarp();

    // O += p v, accumulated through shared memory (the per-row rescale
    // above needs row access that WMMA fragments do not give).
    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], sOw + n * 16, LDS, wmma::mem_row_major);
    mm_ab_acc<D>(sPw, sV, acc);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(sOw + n * 16, acc[n], LDS, wmma::mem_row_major);
    __syncwarp();
  }

  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row >= L) break;
    const float inv = 1.f / sL[warp * 16 + r];
    bf16* o = out + (long long)b * out_bstride + (long long)row * out_rstride + h * D;
    o[lane] = __float2bfloat16(sOw[r * LDS + lane] * inv);
    o[lane + 32] = __float2bfloat16(sOw[r * LDS + lane + 32] * inv);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * gridDim.y + h) * L + row] = sM[warp * 16 + r] + logf(sL[warp * 16 + r]);
  }
}

}  // namespace

// q, k, v: bf16 (B, L, H*64) views sharing strides (batch, row) with unit
// column stride and 16-byte aligned rows; out: bf16 with its own strides;
// lse: null, or float32 (B, H, L) for each row's log-sum-exp of the scaled
// scores (what heads_attention_bwd needs to rebuild the probabilities).
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
