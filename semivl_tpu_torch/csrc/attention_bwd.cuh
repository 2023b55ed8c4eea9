// The one attention backward of both routes, for Hopper (sm_90a):
// flash_attention_heads.cu's heads_attention_bwd launches it for the
// head-split route (D a multiple of 16 up to 128) and, at D = 64, for the
// packed route. The TMA, mbarrier and wgmma pieces are hopper_common.cuh's;
// the tile layouts are attention_fwd.cuh's.
//
// What it computes (semivl_tpu/ops/flash_attention.py::_bwd_kernel and
// ::_packed_bwd_kernel), per (batch, head), from the forward's float32 row
// log-sum-exp: p = exp(s - lse) with s = (q times the bf16 scale, rounded
// to bf16) k^T, delta = rowsum(dO o), ds = p (dO v^T - delta), p and ds
// rounded to bf16 before their products, every product summed in float32:
//   dv = p^T dO,  dk = ds^T q / sqrt(D),  dq = ds k / sqrt(D),
// the 1/sqrt(D) applied in float32 after the product. Keys at or past
// valid_len have p = 0; rows at or past L add nothing.
//
// What bounds it. Five products of 2 L^2 D flops (s, dp, dv, dk and dq;
// the dQ kernel recomputes s and dp: seven in all) on 16 B L C bytes (q,
// k, v, o and dO read, dq, dk and dv written), so the tensor cores at the
// encoder widths (L >= 1025), launch latency at the tiny VLM's and the
// semantic transformer's L <= 21. Each kernel forms p, so two
// exponentials a score.
//
// Design. Blocks run in no order, so two kernels split the work without
// float atomics and reruns agree bit for bit:
//  - prep_kernel: delta, and q times the scale rounded to bf16 ("qs"),
//    written into the dq buffer, which holds nothing else until the dQ
//    kernel overwrites each block's rows with their gradient after
//    reading them. The scale is a power of two only at D = 16 and 64, so
//    qs cannot be folded into the product: s needs qs, dk needs q.
//  - dkdv_kernel: one block per (128 keys, head, batch). Each consumer
//    warpgroup owns 64 keys and keeps dk and dv in wgmma accumulators; one
//    producer thread streams the q side (qs, q, dO tiles of 64 rows)
//    through a TMA ring. The tile's lse log2(e) and delta come from the
//    consumers themselves, one value a thread, loaded while the tile's
//    copy and first products run and shared through a double buffer per
//    warpgroup (the producer, at 24 registers, would spill). Per q tile:
//    s^T = k qs^T and dp^T = v dO^T (wgmma from shared memory, both
//    K-major), p^T and ds^T in registers, then dv += p^T dO and dk += ds^T
//    q with p^T and ds^T from registers in the A-fragment layout and dO, q
//    read by the MN-major (transposed) descriptor, as the forward's p v.
//    A block whose keys are all at or past valid_len loads nothing and
//    writes zeros (dqkv comes from torch.empty).
//  - dq_kernel: one block per (128 q rows, head, batch), qs and dO loaded
//    once, K and V tiles of BKQ keys streamed: s = qs k^T, dp = dO v^T,
//    ds in registers, dq += ds k with the same K tile read through the
//    MN-major descriptor. Key tiles wholly past valid_len are not visited.
//  - Two consumer warpgroups and one producer warpgroup (384 threads, one
//    block an SM, 240 registers a consumer thread, which D = 128's dk and
//    dv accumulators need).
//  - The runtime is called before the tensor maps are encoded: the
//    encode needs a current context, which a fresh host thread (autograd's
//    device thread) has only after its first runtime call.
//  - Rows past L arrive as zeros from TMA; their lse is taken as +inf so
//    p = 0 exactly, and stores stop at row L. Every TMA box is 64 rows by
//    box_cols(D) columns (two boxes across a row at D = 128, three at D =
//    48), swizzled by its row width, so five tensor maps serve both
//    kernels. A product over D columns (dv, dk, dq) at a width without a
//    wgmma instruction of its own here is split by wgmma_rs_mn.

#pragma once

#include "hopper_common.cuh"

namespace attention_bwd {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;   // rows of a TMA box, a warpgroup's share, a q tile of dkdv_kernel
constexpr int NC = 2;      // consumer warpgroups a block
constexpr int NTHREAD = 128 * (NC + 1);
constexpr int BLK = ROWS * NC;   // keys (dkdv) or q rows (dq) of a block
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geometry {
  static constexpr int BOXW = box_cols(D);       // columns of a TMA box
  static constexpr int RB = BOXW * 2;            // bytes of a box row = swizzle span
  static constexpr int NSUB = D / BOXW;          // boxes across a row (2 at D = 128)
  static constexpr int KPS = BOXW / 16;          // 16-column k steps in a box row
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int BKQ = D <= 64 ? 128 : 64;   // keys of a dq_kernel tile
  static constexpr int T = ROWS * D * 2;         // bytes of a 64-row tile
  static constexpr int KT = BKQ * D * 2;         // bytes of a dq_kernel K or V tile
  // 1024 to align the tiles to the swizzle pattern. dkdv: K and V of the
  // block, per stage qs, q and dO tiles, per consumer warpgroup two
  // buffers of a tile's 64 lse log2(e) and 64 delta; dq: qs and dO of the
  // block, per stage a K and a V tile; then the barriers (one, and full
  // and empty per stage)
  static constexpr int SMEM_DKDV =
      1024 + 2 * NC * T + STAGES * 3 * T + NC * 2 * 128 * 4 + 8 * (1 + 2 * STAGES);
  static constexpr int SMEM_DQ = 1024 + 2 * NC * T + STAGES * 2 * KT + 8 * (1 + 2 * STAGES);
};

// TMA rows [r0, r0 + R) of the head's columns [c0, c0 + D) into a tile of
// R rows: NSUB column boxes of R x BOXW, each loaded as R / 64 boxes.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                          int b, uint32_t bar) {
  typedef Geometry<D> G;
#pragma unroll
  for (int sub = 0; sub < G::NSUB; ++sub)
#pragma unroll
    for (int part = 0; part < R / ROWS; ++part)
      tma_load_3d(dst + (sub * R + part * ROWS) * G::RB, map, c0 + sub * G::BOXW,
                  r0 + part * ROWS, b, bar);
}

// K-major descriptor of rows [m0, m0 + 64) of an R-row tile at k step kk.
template <int D, int R>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int m0, int kk) {
  typedef Geometry<D> G;
  return kmajor_desc<G::RB>(tile + ((kk / G::KPS) * R + m0) * G::RB + (kk % G::KPS) * 32);
}

// acc (64 x D) += A B with B rows [16 j, 16 j + 16) of an R-row tile, all
// D columns, MN-major (a product whose reduction runs over the tile's rows).
template <int D, int R>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 2], const uint32_t (&a)[4],
                                         uint32_t tile, int j) {
  typedef Geometry<D> G;
  wgmma_rs_mn<D, G::RB>(acc, a, tile + j * 16 * G::RB, R * G::RB);
}

// delta[b][h][i] = sum_d dO[b][i][h D + d] o[b][i][h D + d], and qs = q
// times qscale rounded to bf16; TPR threads a (row, head) (the largest
// power of two dividing D / 8), each D / TPR values in chunks of 8.
template <int D>
__global__ void prep_kernel(const bf16* __restrict__ q, const bf16* __restrict__ g,
                            const bf16* __restrict__ o, float* __restrict__ delta,
                            bf16* __restrict__ qs, int B, int L, int H, long long in_bstride,
                            long long in_rstride, long long g_bstride, long long g_rstride,
                            long long d_bstride, long long d_rstride, float qscale) {
  constexpr int TPR = (D / 8) & -(D / 8), CHUNKS = D / 8 / TPR;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = t < (long long)B * L * H * TPR;
  const int part = t % TPR, h = (t / TPR) % H;
  const long long row = t / (TPR * H);
  const int i = row % L, b = row / L;
  float s = 0.f;
  if (live) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = h * D + (c * TPR + part) * 8;
      const long long go = b * g_bstride + i * g_rstride + col;
      uint4 gv = *reinterpret_cast<const uint4*>(g + go);
      uint4 ov = *reinterpret_cast<const uint4*>(o + go);
      uint4 qv = *reinterpret_cast<const uint4*>(q + b * in_bstride + i * in_rstride + col);
      const bf16* ge = reinterpret_cast<const bf16*>(&gv);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s = fmaf(__bfloat162float(ge[j]), __bfloat162float(oe[j]), s);
        qe[j] = __float2bfloat16(__bfloat162float(qe[j]) * qscale);
      }
      *reinterpret_cast<uint4*>(qs + b * d_bstride + i * d_rstride + col) = qv;
    }
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (live && part == 0) delta[((long long)b * H + h) * L + i] = s;
}

template <int D>
__global__ void __launch_bounds__(NTHREAD, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mqs, const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mg, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int L, int valid_len, long long d_bstride, long long d_rstride, float gscale) {
  typedef Geometry<D> G;
  constexpr int STAGES = G::STAGES, T = G::T;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + NC * T;
  const uint32_t sQ = sV + NC * T;   // stage s: qs, q, dO at sQ + 3 T s + {0, T, 2 T}
  const uint32_t sStats = sQ + STAGES * 3 * T;   // warpgroup w, buffer x: 128 (w * 2 + x)
  float* stats = reinterpret_cast<float*>(smem_raw + (sStats - raw));
  const uint32_t kv_full = sStats + NC * 2 * 128 * 4;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * STAGES;

  const int k0 = blockIdx.x * BLK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n_q = k0 < valid_len ? (L + ROWS - 1) / ROWS : 0;   // q tiles visited

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 128);    // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128 && n_q > 0) {
      // K and V of the block once, then the q-side tiles through the ring
      mbar_expect_tx(kv_full, 2 * NC * T);
      load_tile<D, BLK>(sK, &mk, h * D, k0, b, kv_full);
      load_tile<D, BLK>(sV, &mv, h * D, k0, b, kv_full);
      for (int it = 0; it < n_q; ++it) {
        const int s = it % STAGES;
        const uint32_t st = sQ + s * 3 * T;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 3 * T);
        load_tile<D, ROWS>(st, &mqs, h * D, it * ROWS, b, full0 + 8 * s);
        load_tile<D, ROWS>(st + T, &mq, h * D, it * ROWS, b, full0 + 8 * s);
        load_tile<D, ROWS>(st + 2 * T, &mg, h * D, it * ROWS, b, full0 + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int key0 = k0 + wg * 64 + warp * 16 + lane / 4;   // this thread's keys: key0, key0 + 8
    const bool edge = k0 + wg * 64 + 64 > valid_len;        // some key of this warpgroup masked
    const float inf = __int_as_float(0x7f800000);
    const long long bh = ((long long)b * H + h) * L;

    float acc_dk[D / 2], acc_dv[D / 2], st[ROWS / 2], dpt[ROWS / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) st[i] = dpt[i] = 0.f;
    if (n_q > 0) mbar_wait(kv_full, 0);

    for (int it = 0; it < n_q; ++it) {
      const int s = it % STAGES;
      const uint32_t tqs = sQ + s * 3 * T, tq = tqs + T, tg = tqs + 2 * T;
      // the tile's lse log2(e) (threads 0-63; +inf past L, so p = 0) and
      // delta (64-127), loaded while the copy and the first products run;
      // two buffers, so no thread writes one that another still reads
      float* lrow = stats + (wg * 2 + (it & 1)) * 128;
      const float* drow = lrow + ROWS;
      const int srow = it * ROWS + tid % ROWS;
      const float stat = srow >= L   ? (tid < ROWS ? inf : 0.f)
                         : tid < ROWS ? lse[bh + srow] * LOG2E
                                      : delta[bh + srow];
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

      // s^T = k qs^T and dp^T = v dO^T: this warpgroup's 64 keys x 64 q rows
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<ROWS>(st, kdesc<D, BLK>(sK, wg * 64, kk), kdesc<D, ROWS>(tqs, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<ROWS>(dpt, kdesc<D, BLK>(sV, wg * 64, kk), kdesc<D, ROWS>(tg, 0, kk), kk > 0);
      wgmma_commit();
      lrow[tid] = stat;
      named_barrier(1 + wg, 128);

      // p^T = exp(s - lse) while dp^T is in flight
      wgmma_wait<1>();
      fence_regs(st);
      if (edge) {
#pragma unroll
        for (int i = 0; i < ROWS / 2; ++i)
          if (key0 + 8 * ((i / 2) % 2) >= valid_len) st[i] = -inf;
      }
      uint32_t pa[ROWS / 16][4];
#pragma unroll
      for (int i = 0; i < ROWS / 2; i += 2) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + (i / 4) * 8 + (lane % 4) * 2);
        st[i] = exp2f(fmaf(st[i], LOG2E, -l2.x));
        st[i + 1] = exp2f(fmaf(st[i + 1], LOG2E, -l2.y));
      }
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[j][x] = pack_bf16(st[8 * j + 2 * x], st[8 * j + 2 * x + 1]);

      // dv += p^T dO, in flight while ds^T is formed
      fence_regs(acc_dv);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j) mma_rows<D, ROWS>(acc_dv, pa[j], tg, j);
      wgmma_commit();

      // ds^T = p^T (dp^T - delta): dp^T's group completes before dv's.
      // Above D = 64 dv completes too, so p^T's registers are free for ds^T
      if constexpr (D > 64) {
        wgmma_wait<0>();
        fence_regs(acc_dv);
        fence_regs(pa);
      } else {
        wgmma_wait<1>();
      }
      fence_regs(dpt);
      uint32_t da[ROWS / 16][4];
#pragma unroll
      for (int i = 0; i < ROWS / 2; i += 2) {
        const float2 d2 = *reinterpret_cast<const float2*>(drow + (i / 4) * 8 + (lane % 4) * 2);
        dpt[i] = st[i] * (dpt[i] - d2.x);
        dpt[i + 1] = st[i + 1] * (dpt[i + 1] - d2.y);
      }
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          da[j][x] = pack_bf16(dpt[8 * j + 2 * x], dpt[8 * j + 2 * x + 1]);

      // dk += ds^T q (scaled at the end)
      fence_regs(acc_dk);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ROWS / 16; ++j) mma_rows<D, ROWS>(acc_dk, da[j], tq, j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dk);
      fence_regs(da);
      if constexpr (D <= 64) {
        fence_regs(acc_dv);
        fence_regs(pa);
      }
      mbar_arrive(empty0 + 8 * s);   // this thread is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= L) continue;
      const long long off = (long long)b * d_bstride + (long long)key * d_rstride + h * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        const int col = (i / 4) * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(dv + off + col) = pack_bf16(acc_dv[i], acc_dv[i + 1]);
        *reinterpret_cast<uint32_t*>(dk + off + col) =
            pack_bf16(acc_dk[i] * gscale, acc_dk[i + 1] * gscale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREAD, 1)
dq_kernel(const __grid_constant__ CUtensorMap mqs, const __grid_constant__ CUtensorMap mg,
          const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
          const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
          int L, int valid_len, long long d_bstride, long long d_rstride, float gscale) {
  typedef Geometry<D> G;
  constexpr int STAGES = G::STAGES, BKQ = G::BKQ, T = G::T, KT = G::KT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sG = sQ + NC * T;
  const uint32_t sK = sG + NC * T;   // stage s: K at sK + 2 KT s, V KT after it
  const uint32_t q_full = sK + STAGES * 2 * KT;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  const int q0 = blockIdx.x * BLK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n_k = (valid_len + BKQ - 1) / BKQ;   // key tiles wholly past valid_len add nothing

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NC * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      // qs (in the dq buffer) and dO of the block's rows once, then the K/V ring
      mbar_expect_tx(q_full, 2 * NC * T);
      load_tile<D, BLK>(sQ, &mqs, h * D, q0, b, q_full);
      load_tile<D, BLK>(sG, &mg, h * D, q0, b, q_full);
      for (int it = 0; it < n_k; ++it) {
        const int s = it % STAGES;
        const uint32_t kt = sK + s * 2 * KT;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * KT);
        load_tile<D, BKQ>(kt, &mk, h * D, it * BKQ, b, full0 + 8 * s);
        load_tile<D, BKQ>(kt + KT, &mv, h * D, it * BKQ, b, full0 + 8 * s);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
    const float inf = __int_as_float(0x7f800000);
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long at = ((long long)b * H + h) * L + row;
      l2[r] = row < L ? lse[at] * LOG2E : inf;   // p = 0 on rows past L
      dl[r] = row < L ? delta[at] : 0.f;
    }

    float acc_dq[D / 2], sc[BKQ / 2], dp[BKQ / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BKQ / 2; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_k; ++it) {
      const int s = it % STAGES;
      const int kb = it * BKQ;
      const uint32_t kt = sK + s * 2 * KT, vt = kt + KT;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

      // s = qs k^T and dp = dO v^T: this warpgroup's 64 rows x BKQ keys
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKQ>(sc, kdesc<D, BLK>(sQ, wg * 64, kk), kdesc<D, BKQ>(kt, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKQ>(dp, kdesc<D, BLK>(sG, wg * 64, kk), kdesc<D, BKQ>(vt, 0, kk), kk > 0);
      wgmma_commit();

      // p = exp(s - lse) while dp is in flight; keys at or past valid_len: 0
      wgmma_wait<1>();
      fence_regs(sc);
      if (kb + BKQ > valid_len) {
#pragma unroll
        for (int i = 0; i < BKQ / 2; ++i)
          if (kb + (i / 4) * 8 + (lane % 4) * 2 + i % 2 >= valid_len) sc[i] = -inf;
      }
#pragma unroll
      for (int i = 0; i < BKQ / 2; ++i) sc[i] = exp2f(fmaf(sc[i], LOG2E, -l2[(i / 2) % 2]));

      // ds = p (dp - delta), to bf16 in the A-fragment layout
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[BKQ / 16][4];
#pragma unroll
      for (int i = 0; i < BKQ / 2; ++i) dp[i] = sc[i] * (dp[i] - dl[(i / 2) % 2]);
#pragma unroll
      for (int j = 0; j < BKQ / 16; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) da[j][x] = pack_bf16(dp[8 * j + 2 * x], dp[8 * j + 2 * x + 1]);

      // dq += ds k: the K tile again, through the MN-major descriptor
      fence_regs(acc_dq);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKQ / 16; ++j) mma_rows<D, BKQ>(acc_dq, da[j], kt, j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
      fence_regs(da);
      mbar_arrive(empty0 + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= L) continue;
      bf16* dst = dq + (long long)b * d_bstride + (long long)row * d_rstride + h * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        const int col = (i / 4) * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(acc_dq[i] * gscale, acc_dq[i + 1] * gscale);
      }
    }
  }
}

// The backward over q, k, v: bf16 (B, L, H*D) views sharing strides (in_*);
// o and g (dO) with the g_* strides; lse float32 (B, H, L); delta float32
// (B, H, L) scratch; dq, dk, dv bf16 with the d_* strides. Returns a CUDA
// error code.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* g,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int L, int H,
           int valid_len, long long in_bstride, long long in_rstride, long long g_bstride,
           long long g_rstride, long long d_bstride, long long d_rstride, float qscale,
           float gscale, cudaStream_t st) {
  typedef Geometry<D> G;
  const int C = H * D;
  // runtime calls first: they make the device's context current in this
  // thread, which the tensor-map encode needs
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_DKDV);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  constexpr int TPR = (D / 8) & -(D / 8);   // prep_kernel's threads a (row, head)
  const long long threads = (long long)B * L * H * TPR;
  prep_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const bf16*)q, (const bf16*)g, (const bf16*)o, (float*)delta, (bf16*)dq, B, L, H,
      in_bstride, in_rstride, g_bstride, g_rstride, d_bstride, d_rstride, qscale);
  CUtensorMap mq, mk, mv, mqs, mg;
  if (!tensor_map_3d(&mq, q, C, L, B, in_rstride, in_bstride, G::BOXW, ROWS) ||
      !tensor_map_3d(&mk, k, C, L, B, in_rstride, in_bstride, G::BOXW, ROWS) ||
      !tensor_map_3d(&mv, v, C, L, B, in_rstride, in_bstride, G::BOXW, ROWS) ||
      !tensor_map_3d(&mqs, dq, C, L, B, d_rstride, d_bstride, G::BOXW, ROWS) ||
      !tensor_map_3d(&mg, g, C, L, B, g_rstride, g_bstride, G::BOXW, ROWS))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((L + BLK - 1) / BLK, H, B);
  dkdv_kernel<D><<<grid, NTHREAD, G::SMEM_DKDV, st>>>(
      mk, mv, mqs, mq, mg, (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, L,
      valid_len, d_bstride, d_rstride, gscale);
  dq_kernel<D><<<grid, NTHREAD, G::SMEM_DQ, st>>>(
      mqs, mg, mk, mv, (const float*)lse, (const float*)delta, (bf16*)dq, L, valid_len,
      d_bstride, d_rstride, gscale);
  return (int)cudaGetLastError();
}

}  // namespace attention_bwd
