// The one attention forward core of both routes, for Hopper (sm_90a):
// flash_attention.cu instantiates it for the packed route (D = 64, one
// pass with an online softmax), flash_attention_heads.cu for the head-split
// route (D a multiple of 16 up to 128; two passes). The TMA, mbarrier and
// wgmma pieces are hopper_common.cuh's.
//
// What bounds it. 4 B H L^2 D flops on 8 B L C bytes of q, k, v and out:
// L / 2 flops a byte, so about 690 at L = 1025 and 1650 at L = 2602 (12
// heads of 64): far above the card's 295, so the tensor cores bound it
// there (0.0065 ms and 0.042 ms at 989 TFLOP/s); the tiny VLM's L = 17 and
// 21 are bound by launch latency. Next to the tensor cores the exponentials
// count: one per score on the special-function units (16 a clock per SM
// against 4096 bf16 flops), as many clocks as the two products take at
// D = 64. So the design keeps every score in registers, overlaps the tile
// copies with the products, and lets two warpgroups take turns on the
// tensor cores and the exponentials.
//
// Design. One block per (128 q rows, head, batch): two consumer
// warpgroups of 64 rows and one producer warpgroup, of which one thread
// issues every copy. (A 64-row variant was not taken: at L = 1025 it would
// give 408 blocks, 3.1 waves of one block per SM, against 216 blocks, 1.6
// waves; the tiny shapes are one ragged tile either way.)
//  - TMA. Q is copied once; K and V tiles of BK = 128 keys go through a
//    ring of STAGES stages, each completing on an mbarrier and released by
//    the consumers on another, so the next tiles' copies run under this
//    tile's products. The tensor maps are 3D over each view (columns, L
//    rows, batch) with its own row and batch strides, the head's column
//    offset in the box coordinates; rows past L arrive as zeros.
//  - Swizzle follows the row: a tile row is D / BOXW boxes of BOXW =
//    box_cols(D) bf16 (64, 32 or 16: two boxes of 64 at D = 128, three of
//    16 at D = 48), 128, 64 or 32 bytes a box row and swizzled by as much.
//    The wgmma descriptors describe the same boxes.
//  - S = Q K^T: wgmma m64n128k16 from shared memory, both K-major, D / 16
//    steps, the 64 x 128 float32 scores in registers (64 a thread).
//  - Softmax in registers: a thread holds parts of two rows, so a row's
//    max and sum take two shuffles within a quad of lanes.
//  - O += P V: P is converted from the score registers to bf16 in the
//    A-fragment layout (the accumulator's layout, so no data moves), V read
//    from shared memory by the MN-major (transposed) descriptor.
//  - The consumers take 240 registers each, the producer 24 (setmaxnreg).
//
// Numerics, as the TPU kernels round:
//  - q times the scale is rounded to bf16 in shared memory before q k^T.
//  - Packed (semivl_tpu/ops/flash_attention.py::_packed_fwd_kernel):
//    online float32 softmax over 128-key tiles; the unnormalised p =
//    exp(s - running max) is rounded to bf16 for p v, against the running
//    max that includes its own tile, earlier sums rescaled; the float32 row
//    sum of the unrounded p divided out at the end. exp is exp2 on
//    log2(e)-scaled scores. ops/flash_attention.py::_fwd_rounded is this
//    arithmetic; its _BK is BK.
//  - Head-split (::_fwd_kernel): the TPU kernel normalises p before the
//    bf16 cast, so pass 1 runs q k^T alone (no V copies) for each row's max
//    m and sum l of exp(s - m), online; pass 2 recomputes q k^T and forms
//    p = exp(s - m) / l (as exp2 of log2(e)-scaled scores times one
//    reciprocal of l per row) rounded to bf16, O += p v with no rescale.
//    It rounds where JAX does; exp2 and the reciprocal move p by a float32
//    ulp or two before its bf16 rounding, as the order of sums does.
//  - Keys at or past valid_len score -1e30; tiles wholly past it are not
//    visited (their p underflows to 0). lse = m + log(l) when asked for.

#pragma once

#include "hopper_common.cuh"

namespace attention_fwd {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // q rows per block (two consumer warpgroups)
constexpr int BK = 128;        // keys per tile (_BK of ops/flash_attention.py)
constexpr int NTHREAD = 384;   // 2 consumer warpgroups + 1 producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geometry {
  static constexpr int BOXW = box_cols(D);       // columns of a TMA box
  static constexpr int RB = BOXW * 2;            // bytes of a box row = swizzle span
  static constexpr int NSUB = D / BOXW;          // boxes across a row (2 at D = 128)
  static constexpr int KPS = BOXW / 16;          // 16-column k steps in a box row
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  // 1024 to align the tiles to the swizzle pattern; barriers: Q, then full
  // and empty per stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D, bool TWO_PASS>
__global__ void __launch_bounds__(NTHREAD, 1)
fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
           float* __restrict__ lse, int L, int valid_len, long long out_bstride,
           long long out_rstride, float qscale) {
  typedef Geometry<D> G;
  constexpr int RB = G::RB, STAGES = G::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* q_tile = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + G::Q_BYTES;
  const uint32_t sV = sK + STAGES * G::KV_BYTES;
  const uint32_t q_full = sV + STAGES * G::KV_BYTES;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (valid_len + BK - 1) / BK;
  const int n_items = TWO_PASS ? 2 * n_tiles : n_tiles;   // tiles visited, both passes

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);   // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread issues Q, then the K (and V) ring
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, G::Q_BYTES);
      for (int sub = 0; sub < G::NSUB; ++sub)
        tma_load_3d(sQ + sub * BM * RB, &mq, h * D + sub * G::BOXW, q0, b, q_full);
      for (int it = 0; it < n_items; ++it) {
        const int s = it % STAGES;
        const bool with_v = !TWO_PASS || it >= n_tiles;
        const int k0 = (it >= n_tiles ? it - n_tiles : it) * BK;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, with_v ? 2 * G::KV_BYTES : G::KV_BYTES);
        for (int sub = 0; sub < G::NSUB; ++sub) {
          const int c = h * D + sub * G::BOXW;
          const uint32_t off = s * G::KV_BYTES + sub * BK * RB;
          tma_load_3d(sK + off, &mk, c, k0, b, full0 + 8 * s);
          if (with_v) tma_load_3d(sV + off, &mv, c, k0, b, full0 + 8 * s);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8

    // q times the bf16 scale, in place: this warpgroup's 64 rows of each box
    mbar_wait(q_full, 0);
    if (qscale != 1.f) {
      for (int sub = 0; sub < G::NSUB; ++sub) {
        uint4* p = reinterpret_cast<uint4*>(q_tile + sub * BM * RB + wg * 64 * RB);
        for (int i = tid; i < 64 * RB / 16; i += 128) {
          uint4 v = p[i];
          bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * qscale);
          p[i] = v;
        }
      }
      fence_proxy_async();
    }
    named_barrier(1 + wg, 128);
    const uint32_t qa = sQ + wg * 64 * RB;

    float o[D / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    const float neg_inf = __int_as_float(0xff800000);
    float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};

    for (int it = 0; it < n_items; ++it) {
      const int s = it % STAGES;
      const bool second = TWO_PASS && it >= n_tiles;   // pass 2 of the head-split forward
      const int k0 = (it >= n_tiles ? it - n_tiles : it) * BK;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

      // S = (q scale) K^T for this warpgroup's 64 rows and 128 keys
      const uint32_t kt = sK + s * G::KV_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sc, kmajor_desc<RB>(qa + (kk / G::KPS) * BM * RB + (kk % G::KPS) * 32),
                      kmajor_desc<RB>(kt + (kk / G::KPS) * BK * RB + (kk % G::KPS) * 32),
                      kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (k0 + BK > valid_len) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (k0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2 >= valid_len) sc[i] = -1e30f;
      }

      if (TWO_PASS && !second) {
        // pass 1: running row max and sum of exp(s - max), on exp2
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if ((i / 2) % 2 == r) mx = fmaxf(mx, sc[i]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mb = mx * LOG2E;
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if ((i / 2) % 2 == r) sum += exp2f(fmaf(sc[i], LOG2E, -mb));
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[r] = l[r] * exp2f((m[r] - mx) * LOG2E) + sum;   // 0 on the first tile
          m[r] = mx;
        }
        if (it == n_tiles - 1) {
          rl[0] = 1.f / l[0];
          rl[1] = 1.f / l[1];
        }
      } else {
        uint32_t pa[BK / 16][4];
        if (TWO_PASS) {
          // pass 2: p = exp(s - m) / l, as exp2 times 1 / l
          const float mb[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int r = (i / 2) % 2;
            sc[i] = exp2f(fmaf(sc[i], LOG2E, -mb[r])) * rl[r];
          }
        } else {
          // online softmax: rescale the earlier sums to the new running max
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = m[r];
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
              if ((i / 2) % 2 == r) mx = fmaxf(mx, sc[i]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float corr = exp2f((m[r] - mx) * LOG2E);   // 0 on the first tile
            const float mb = mx * LOG2E;
            float sum = 0.f;
#pragma unroll
            for (int i = 0; i < BK / 2; ++i)
              if ((i / 2) % 2 == r) {
                sc[i] = exp2f(fmaf(sc[i], LOG2E, -mb));
                sum += sc[i];
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l[r] = l[r] * corr + sum;
            m[r] = mx;
#pragma unroll
            for (int i = 0; i < D / 2; ++i)
              if ((i / 2) % 2 == r) o[i] *= corr;
          }
        }
        // p to bf16 in the A-fragment layout, 16 keys per k step
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[j][x] = pack_bf16(sc[8 * j + 2 * x], sc[8 * j + 2 * x + 1]);

        // O += P V
        const uint32_t vt = sV + s * G::KV_BYTES;
        fence_regs(o);
        fence_regs(pa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          wgmma_rs_mn<D, RB>(o, pa[j], vt + j * 16 * RB, BK * RB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
      }
      mbar_arrive(empty0 + 8 * s);   // this thread is done with the stage
    }

    // out = O / l (packed) or O (head-split, p already normalised)
    const int H = gridDim.y;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= L) continue;
      const float mul = TWO_PASS ? 1.f : 1.f / l[r];
      bf16* dst = out + (long long)b * out_bstride + (long long)row * out_rstride + h * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        const int col = (i / 4) * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(o[i] * mul, o[i + 1] * mul);
      }
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * H + h) * L + row] = m[r] + logf(l[r]);
    }
  }
}

// Launch the forward over q, k, v: bf16 (B, L, H*D) views sharing strides
// (batch, row; unit column stride, 16-byte aligned); out with its own
// strides; lse null or float32 (B, H, L). Returns a CUDA error code.
template <int D, bool TWO_PASS>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
           int H, int valid_len, long long in_bstride, long long in_rstride,
           long long out_bstride, long long out_rstride, float qscale, cudaStream_t stream) {
  typedef Geometry<D> G;
  // a runtime call first: it makes the device's context current in this
  // thread (a fresh one, such as autograd's, has none), which the
  // tensor-map encode needs
  auto kernel = fwd_kernel<D, TWO_PASS>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  const int C = H * D;
  if (!tensor_map_3d(&mq, q, C, L, B, in_rstride, in_bstride, G::BOXW, BM) ||
      !tensor_map_3d(&mk, k, C, L, B, in_rstride, in_bstride, G::BOXW, BK) ||
      !tensor_map_3d(&mv, v, C, L, B, in_rstride, in_bstride, G::BOXW, BK))
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + BM - 1) / BM, H, B);
  kernel<<<grid, NTHREAD, G::SMEM, stream>>>(mq, mk, mv, (bf16*)out, (float*)lse, L,
                                             valid_len, out_bstride, out_rstride, qscale);
  return (int)cudaGetLastError();
}

}  // namespace attention_fwd
