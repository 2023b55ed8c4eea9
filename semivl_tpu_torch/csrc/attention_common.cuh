// Device code of the one attention backward of both routes
// (flash_attention_heads.cu): tile sizes, the warp sum, the pitched 64-row
// tile load and the WMMA bf16 16x16x16 products with float32
// accumulation, templated on the head width D. The forwards are
// attention_fwd.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace attention {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;             // q rows per block
constexpr int BK = 64;             // keys per tile
constexpr int NWARP = BQ / 16;     // 4 warps, 16 rows (or keys) each
constexpr int NTHREAD = NWARP * 32;
constexpr int LDP = BK + 8;        // bf16 pitch of a warp's 16 x 64 p tile
constexpr int LDS = BK + 4;        // float pitch of a warp's 16 x 64 scores

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

// Shared-memory sizes (bytes) for head width D: a 64-row bf16 tile of one
// head (pitch D + 8), the warps' bf16 p tiles and their float score tiles.
template <int D>
struct Sizes {
  static constexpr int LD = D + 8;
  static constexpr int TILE = BQ * LD * 2;
  static constexpr int P = NWARP * 16 * LDP * 2;
  static constexpr int SCORES = NWARP * 16 * LDS * 4;
  static constexpr int STATS = 2 * BQ * 4;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [r0, r0 + 64) of one head (D bf16, D / 8 vectors of 16 B) into
// a pitched shared tile; rows at or past L are zeros. With `scale` != 1
// each value is multiplied in float32 and rounded back to bf16.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int L,
                                          long long rstride, float scale) {
  constexpr int V = D / 8, LD = D + 8;
  for (int c = threadIdx.x; c < BQ * V; c += NTHREAD) {
    const int r = c / V, col = (c % V) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rstride + col);
      if (scale != 1.0f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// out (16 x 64, float, pitch LDS) = A B^T: A 16 rows of D (pitch D + 8), B
// 64 rows of D (pitch D + 8).
template <int D>
__device__ __forceinline__ void mm_abt(const bf16* a, const bf16* bm, float* out) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LD);
      wmma::load_matrix_sync(fb, bm + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] += A B: A 16 x 64 (bf16, pitch LDP), B 64 rows of D (pitch D + 8).
template <int D>
__device__ __forceinline__ void mm_ab_acc(const bf16* a, const bf16* bm, FragC* acc) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDP);
      wmma::load_matrix_sync(fb, bm + kk * 16 * LD + n * 16, LD);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write a warp's 16 x D accumulator rows [row0, row0 + 16) (rows >= L
// skipped) as bf16 times `mul`, 64 columns at a time through the float
// staging tile `st` (16 x 64, pitch LDS).
template <int D>
__device__ __forceinline__ void store_rows(FragC* acc, float* st, bf16* dst, int row0, int L,
                                           long long rstride, float mul, int lane) {
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += 64) {
    constexpr int W = D < 64 ? D : 64;
#pragma unroll
    for (int n = 0; n < W / 16; ++n)
      wmma::store_matrix_sync(st + n * 16, acc[c0 / 16 + n], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16 && row0 + r < L; ++r) {
      bf16* o = dst + (long long)(row0 + r) * rstride + c0;
      for (int col = lane; col < W; col += 32) o[col] = __float2bfloat16(st[r * LDS + col] * mul);
    }
    __syncwarp();
  }
}

}  // namespace attention
