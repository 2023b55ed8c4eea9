// Tensor-core 3x3 convolution and plain GEMM cores for the decoder, on
// Hopper (sm_90a): implicit GEMM on wgmma with bf16 operands and float32
// accumulators, every operand tile brought in by TMA through a ring of
// shared-memory stages (one producer warp, consumer warpgroups that release
// each stage on an mbarrier), on the helpers of hopper_common.cuh.
// The decoder forward and the fused Up stage (fused_decoder.cu, kernels #5
// and #11), the whole-plane backward (fused_decoder_bwd.cu, #6 and #7) and
// the banded backward's three passes (fused_decoder_banded.cu, #8-#10) are
// built on it, through the sequences of decoder_stage_bwd.cuh.
//
// Two kernels:
//  - conv_kernel<N, TAPS>: out[pix][n] = sum_k A[pix][k] B[k][n] over a
//    tile of 4 image rows x 64 pixels (M = 256, two consumer warpgroups of
//    two rows each, 232 registers a thread; the producer warpgroup, of
//    which one thread issues the copies, hands its registers over with
//    setmaxnreg). TAPS = 9 is a 3x3 convolution with padding 1, K = 9 C:
//    for each chunk of kc input channels and each column shift dx, one
//    stage holds the 6 input rows y0 - 1 .. y0 + 4 of the source's copy
//    shifted by dx - 1 columns (one TMA box of 64 pixels x kc channels
//    each; the three row shifts dy are slabs of the same stage) and the
//    weights of the three taps (dy, dx).
//    TAPS = 1 is a plain product over the channels (the 2x2 stride-2
//    transpose convolution, forward per output phase and its input
//    gradient), K = C. A is the activation tile as it lies in NCHW memory,
//    64 pixels contiguous per channel: MN-major (transposed A, bf16 only).
//    B is the weight box [n][kc], K-major. Padding and ragged edges are
//    TMA's out-of-bounds zeros. Blocks are persistent over the tiles, so
//    the producer loads the next tile while the consumers store this one.
//    The epilogue (conv_epilogue) stores bf16 or float32 NCHW, adds a
//    per-image float32 addend (conv1's skip half), writes per-tile
//    GroupNorm partial sums of the stored values, or scatters into the
//    transpose conv's output phases or into a phase-separated gradient.
//    A bf16 NCHW output of N <= 64 channels goes through shared memory
//    (each warpgroup's two rows as lines of 64 pixels: bf16, or float32
//    where the addend comes before the rounding), so a warp reads the
//    addend and stores a whole line with one coalesced instruction each:
//    the accumulator layout gives each instruction pieces of four lines,
//    and the addend's loads, between the stores, waited for each other.
//  - wgrad_kernel<N, TAPS>: gW[tap][m][n] = sum_pix A[m][pix + tap]
//    g[n][pix], M = the input channels (64-row tiles), N = the output
//    channels, K = pixels, both operands K-major (pixels contiguous).
//    Block (dx, m-tile, slot) walks every gridDim.y-th (plane, 2-row x
//    64-pixel) item and keeps the three taps (dy, dx) in registers; the
//    slots' partials are added in a fixed order afterwards (no float
//    atomics: reruns agree bit for bit).
//
// Sources are bf16 planes read through a 3D map (X columns at a row pitch
// that is a multiple of 8 elements, H rows, channels x planes). TMA starts
// a 128-byte-swizzled box only at a column that is a multiple of 8
// elements, so the A source of a 3x3 kernel is first copied three times,
// moved by -1, 0 and +1 columns (shift_copy_kernel; the copy also takes
// the planes to such a pitch), and each column shift reads its own copy at
// aligned columns; rows outside the plane arrive as TMA's zeros. Other
// sources are read in place, or through a pitch copy when their width is
// not a multiple of 8.

#pragma once

#include "hopper_common.cuh"

namespace igemm {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int TW = 64;                 // pixels of a tile row: one 128-byte swizzle span
constexpr int CONV_ROWS = 4;           // image rows of a conv tile
constexpr int CONV_THREADS = 384;      // two consumer warpgroups + one producer warpgroup
constexpr int WG_ROWS = 2;             // image rows of a wgrad item
constexpr int WG_THREADS = 160;        // one consumer warpgroup + one producer warp
constexpr int SMEM_BUDGET = 200 * 1024;   // the ring of a kernel, at most
constexpr int SMEM_MAX = 227 * 1024;      // a block's dynamic shared memory
constexpr int OUT_PITCH = TW + 4;         // a staged output line: 64 pixels + 4 (banks)

// d (64 x N) += A B, both from shared memory: wgmma_ss_t* with A MN-major
// (transposed), wgmma_ss_k* with A K-major; B K-major in both.

__device__ __forceinline__ void wgmma_ss_k16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_k32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_k48(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_k64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_k96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_k128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t48(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t96(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_t128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(1));
}

template <int N, int TA>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (TA) {
    if constexpr (N == 16) wgmma_ss_t16(d, a, b);
    else if constexpr (N == 32) wgmma_ss_t32(d, a, b);
    else if constexpr (N == 48) wgmma_ss_t48(d, a, b);
    else if constexpr (N == 64) wgmma_ss_t64(d, a, b);
    else if constexpr (N == 96) wgmma_ss_t96(d, a, b);
    else wgmma_ss_t128(d, a, b);
  } else {
    if constexpr (N == 16) wgmma_ss_k16(d, a, b);
    else if constexpr (N == 32) wgmma_ss_k32(d, a, b);
    else if constexpr (N == 48) wgmma_ss_k48(d, a, b);
    else if constexpr (N == 64) wgmma_ss_k64(d, a, b);
    else if constexpr (N == 96) wgmma_ss_k96(d, a, b);
    else wgmma_ss_k128(d, a, b);
  }
}

// ------------------------------------------------------------------ conv

enum EpiMode { EPI_BF16 = 0, EPI_F32 = 1, EPI_PHASE = 2, EPI_TCONV = 3 };

// What conv_kernel does with a tile's sums. Output geometry is the tile
// grid's (H x W) unless stated.
// Every mode writes N channels of an output plane of `cstride` channels
// (0: N), from the channel `out` points at: a column group of a wider
// output (conv_cols) or the whole of it.
struct Epi {
  int mode;
  void* out;           // EPI_BF16 / EPI_F32: [planes][cstride][H][W]; EPI_PHASE: bf16
                       // [planes][4][cstride][H / 2][pitch] (phase ky * 2 + kx of the
                       // (H, W) output); EPI_TCONV: bf16 [planes][cstride][2H][2W],
                       // the tile's sums landing on output phase `split`
  const float* add;    // EPI_BF16: float32 addend [plane / add_rep][cstride][H][W] or
                       // null, from the channel it points at
  int add_rep;
  const float* bias;   // EPI_TCONV: [N]
  float* gn_part;      // EPI_BF16: GroupNorm partials [planes][cstride / 16][tiles][2] or
                       // null, from the chunk it points at
  int pitch;           // EPI_PHASE: row pitch of the phase planes
  int cstride;         // channels of an output plane (0: N)
  bool promote;        // add each K step's products into the sums on the CUDA cores
};

struct ConvArgs {
  int planes, C, H, W;          // the A source: planes of C channels, H x W
  int kc, nchunks;              // channels per K step; C / kc
  int nsplit;                   // B batches per tile (4 output phases of the transpose conv)
  int tiles_x, tiles_y, items;  // items = planes * tiles_y * tiles_x * nsplit
  int stages;
  uint32_t a_bytes, b_bytes, stage_bytes;   // a slab, a B box (1024-aligned), a stage
  Epi epi;
};

// Whether conv_kernel<N> stages a tile's output in shared memory.
__host__ __device__ constexpr bool staged_out(int n, int mode) {
  return n <= 64 && mode == EPI_BF16;
}

// Writes a warpgroup's staged lines s_out [2 rows][N][OUT_PITCH] of T
// (rows y0, y0 + 1 from column x0) to out [p][N][H][W] in bf16 and adds
// the stored values to the GroupNorm sums gs, gq. Lines of float32 take
// e.add's addend before the rounding (lines of bf16 are rounded already,
// with no addend). Warp w takes lines w, w + 4, ...; a lane 2 pixels (a
// 4-byte store where W is even), so a warp reads and writes a line of 64
// pixels with one coalesced instruction each; the addend of all its lines
// is loaded first, all in flight at once.
template <int N, typename T>
__device__ __forceinline__ void store_lines(const T* s_out, const Epi& e, int p, int y0, int x0,
                                            int H, int W, int warp, int lane, float* gs,
                                            float* gq) {
  constexpr int L = 2 * N / 4;   // lines a warp writes
  constexpr bool ADD = sizeof(T) == 4;
  const size_t hw = (size_t)H * W;
  const int x = x0 + 2 * lane;
  const bool even = (W & 1) == 0;
  float2 add[ADD ? L : 1];
  if constexpr (ADD) {
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int line = warp + 4 * k, y = y0 + line / N;
      add[k] = make_float2(0.f, 0.f);
      if (y >= H || x >= W) continue;
      const float* a = e.add + ((size_t)(p / e.add_rep) * e.cstride + line % N) * hw + (size_t)y * W + x;
      if (even) {
        add[k] = __ldg(reinterpret_cast<const float2*>(a));
      } else {
        add[k].x = __ldg(a);
        if (x + 1 < W) add[k].y = __ldg(a + 1);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int line = warp + 4 * k, y = y0 + line / N;
    const int g = (4 * k % N) / 16;   // the group of channel line % N (warp < 4)
    if (y >= H || x >= W) continue;
    const T* s = s_out + line * OUT_PITCH + 2 * lane;
    __nv_bfloat162 o;
    if constexpr (ADD) {
      const float2 v = *reinterpret_cast<const float2*>(s);
      o = __floats2bfloat162_rn(v.x + add[k].x, v.y + add[k].y);
    } else {
      o = *reinterpret_cast<const __nv_bfloat162*>(s);
    }
    const float2 f = __bfloat1622float2(o);   // statistics of the stored values
    bf16* d =
        static_cast<bf16*>(e.out) + ((size_t)p * e.cstride + line % N) * hw + (size_t)y * W + x;
    if (even) {
      *reinterpret_cast<__nv_bfloat162*>(d) = o;
      gs[g] += f.x + f.y;
      gq[g] += f.x * f.x + f.y * f.y;
    } else {
      d[0] = o.x;
      gs[g] += f.x;
      gq[g] += f.x * f.x;
      if (x + 1 < W) {
        d[1] = o.y;
        gs[g] += f.y;
        gq[g] += f.y * f.y;
      }
    }
  }
}

// A bf16 output through shared memory: this warpgroup's two rows of the
// tile as lines of T (float32 when an addend comes before the rounding,
// else bf16), then store_lines.
template <int N, typename T>
__device__ __forceinline__ void staged_epilogue(const float (&acc)[2][N / 2], void* s_out,
                                                const Epi& e, int p, int ty, int tx, int H,
                                                int W, float* gs, float* gq) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  T* so = static_cast<T*>(s_out) + wg * 2 * N * OUT_PITCH;
  named_barrier(2 + wg, 128);   // the previous tile's lines are out
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int xl = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      if constexpr (sizeof(T) == 4) so[(r * N + n) * OUT_PITCH + xl] = acc[r][i];
      else so[(r * N + n) * OUT_PITCH + xl] = __float2bfloat16(acc[r][i]);
    }
  named_barrier(2 + wg, 128);
  store_lines<N, T>(so, e, p, ty * CONV_ROWS + wg * 2, tx * TW, H, W, warp, lane, gs, gq);
}

template <int N>
__device__ __forceinline__ void conv_epilogue(const ConvArgs& a, float (&acc)[2][N / 2], int p,
                                              int ty, int tx, int split, float* s_gn,
                                              float* s_out) {
  const Epi& e = a.epi;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int H = a.H, W = a.W;
  const size_t hw = (size_t)H * W;
  constexpr int G = N / 16 > 0 ? N / 16 : 1;
  float gs[G], gq[G];
#pragma unroll
  for (int g = 0; g < G; ++g) gs[g] = gq[g] = 0.f;
  if (staged_out(N, e.mode)) {
    if (e.add != nullptr) staged_epilogue<N, float>(acc, s_out, e, p, ty, tx, H, W, gs, gq);
    else staged_epilogue<N, bf16>(acc, s_out, e, p, ty, tx, H, W, gs, gq);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = ty * CONV_ROWS + wg * 2 + r;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int x = tx * TW + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (y >= H || x >= W) continue;
        float v = acc[r][i];
        const size_t pix = (size_t)y * W + x;
        if (e.mode == EPI_BF16) {
          if (e.add != nullptr) v += e.add[((size_t)(p / e.add_rep) * e.cstride + n) * hw + pix];
          const bf16 o = __float2bfloat16(v);
          static_cast<bf16*>(e.out)[((size_t)p * e.cstride + n) * hw + pix] = o;
          v = __bfloat162float(o);   // statistics of the stored values
          gs[i / 8] += v;   // group n / 16 = i / 8
          gq[i / 8] += v * v;
        } else if (e.mode == EPI_F32) {
          static_cast<float*>(e.out)[((size_t)p * e.cstride + n) * hw + pix] = v;
        } else if (e.mode == EPI_PHASE) {
          const int ph = (y & 1) * 2 + (x & 1);
          static_cast<bf16*>(e.out)[(((size_t)p * 4 + ph) * e.cstride + n) * (H / 2) *
                                        (size_t)e.pitch +
                                    (size_t)(y >> 1) * e.pitch + (x >> 1)] = __float2bfloat16(v);
        } else {   // EPI_TCONV
          const int oy = 2 * y + split / 2, ox = 2 * x + split % 2;
          const size_t o = ((size_t)p * e.cstride + n) * 4 * hw + (size_t)oy * 2 * W + ox;
          static_cast<bf16*>(e.out)[o] = __float2bfloat16(v + e.bias[n]);
        }
      }
    }
  }
  if (e.mode != EPI_BF16 || e.gn_part == nullptr) return;
  // per-group sums of the threads' stored values (gs[g], gq[g])
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gs[g] += __shfl_xor_sync(0xffffffffu, gs[g], o);
      gq[g] += __shfl_xor_sync(0xffffffffu, gq[g], o);
    }
  }
  const int wid = threadIdx.x / 32;
  named_barrier(1, 256);   // s_gn is free (the previous tile's reads are done)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_gn[(wid * G + g) * 2] = gs[g];
      s_gn[(wid * G + g) * 2 + 1] = gq[g];
    }
  }
  named_barrier(1, 256);
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float s = 0.f, q = 0.f;
    for (int w = 0; w < 8; ++w) {
      s += s_gn[(w * G + g) * 2];
      q += s_gn[(w * G + g) * 2 + 1];
    }
    const int tiles = a.tiles_x * a.tiles_y;
    float* o = e.gn_part +
               (((size_t)p * (e.cstride / 16) + g) * tiles + ty * a.tiles_x + tx) * 2;
    o[0] = s;
    o[1] = q;
  }
}

// One K step of the conv kernel for this warpgroup's two rows: KS
// 16-channel steps of each row shift dy (the slab wg * 2 + r + dy, the B box
// of tap row dy), all unrolled so the accumulators stay put under wgmma.
template <int N, int KS, int NDY>
__device__ __forceinline__ void conv_step(float (&acc)[2][N / 2], uint32_t sa, uint32_t sb,
                                          uint32_t a_bytes, uint32_t b_bytes, int wg) {
  constexpr int RB = KS * 32;   // bytes of a B box row: kc = 16 KS channels
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int dy = 0; dy < NDY; ++dy) {
      const uint32_t a0 = sa + (wg * 2 + r + dy) * a_bytes, b0 = sb + dy * b_bytes;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma<N, 1>(acc[r], mnmajor_desc<128>(a0 + kk * 2048, a_bytes),
                  kmajor_desc<RB>(b0 + kk * 32));
    }
}

// Issue one K step's products into d for this warpgroup and wait for them.
template <int N, int NDY>
__device__ __forceinline__ void conv_issue(float (&d)[2][N / 2], uint32_t sa, uint32_t sb,
                                           const ConvArgs& a, int wg) {
  fence_regs(d[0]);
  fence_regs(d[1]);
  wgmma_fence();
  if (a.kc == 64) conv_step<N, 4, NDY>(d, sa, sb, a.a_bytes, a.b_bytes, wg);
  else if (a.kc == 32) conv_step<N, 2, NDY>(d, sa, sb, a.a_bytes, a.b_bytes, wg);
  else conv_step<N, 1, NDY>(d, sa, sb, a.a_bytes, a.b_bytes, wg);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d[0]);
  fence_regs(d[1]);
}

template <int N, int TAPS>
__global__ void __launch_bounds__(CONV_THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
            const ConvArgs a) {
  constexpr int SLABS = TAPS == 9 ? CONV_ROWS + 2 : CONV_ROWS;
  constexpr int NDX = TAPS == 9 ? 3 : 1;   // column shifts: K steps per channel chunk
  constexpr int NDY = TAPS == 9 ? 3 : 1;   // row shifts: slabs (and B boxes) per K step
  // With epi.promote, each K step's products go into fresh accumulators,
  // which are then added to the tile's sums on the CUDA cores (float32,
  // round to nearest). Chained over all of K, wgmma's accumulation flipped
  // more bf16 roundings of the stored outputs than float32 sums do, and the
  // GroupNorm after each conv amplifies every flip; per K step it flips no
  // more than float32 sums (tools/decoder_precision.py). The stage
  // forward's products ask for it (stage_recompute), the backward's do
  // not. N = 128 (only the transpose conv's products, K at most 4 x 128)
  // keeps one set of accumulators: two would not fit the consumers' 232
  // registers.
  constexpr bool PROMOTE = N <= 96;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + a.stages * a.stage_bytes, empty0 = full0 + 8 * a.stages;
  float* s_gn = reinterpret_cast<float*>(smem_raw + (empty0 + 8 * a.stages - raw));
  float* s_out = s_gn + 8 * 8 * 2;   // staged_out's lines (float32 or bf16)
  const int ksteps = a.nchunks * NDX;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);   // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const uint32_t tx_bytes = SLABS * a.a_bytes + NDY * (uint32_t)N * a.kc * 2;
      int it = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
        int t = item;
        const int split = t % a.nsplit;
        t /= a.nsplit;
        const int tx = t % a.tiles_x;
        t /= a.tiles_x;
        const int ty = t % a.tiles_y, p = t / a.tiles_y;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          const int s = it % a.stages, chunk = ks / NDX, dx = ks % NDX;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((it / a.stages) & 1) ^ 1);
          mbar_expect_tx(full, tx_bytes);
          const uint32_t sa = base + s * a.stage_bytes, sb = sa + SLABS * a.a_bytes;
          // 3x3: the column shift dx is the copy of the source shifted by
          // dx - 1 (shifted_source): TMA takes a box only at a column that
          // is a whole number of 16-byte units into the row
          const int ch = ((TAPS == 9 ? dx * a.planes : 0) + p) * a.C + chunk * a.kc;
          const int x = tx * TW, y = ty * CONV_ROWS - (TAPS == 9 ? 1 : 0);
          for (int j = 0; j < SLABS; ++j) tma_load_3d(sa + j * a.a_bytes, &ma, x, y + j, ch, full);
          for (int dy = 0; dy < NDY; ++dy)
            tma_load_3d(sb + dy * a.b_bytes, &mb, chunk * a.kc, 0,
                        TAPS == 9 ? dy * 3 + dx : split, full);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    float acc[2][N / 2];
    int it = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      int t = item;
      const int split = t % a.nsplit;
      t /= a.nsplit;
      const int tx = t % a.tiles_x;
      t /= a.tiles_x;
      const int ty = t % a.tiles_y, p = t / a.tiles_y;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.f;
      for (int ks = 0; ks < ksteps; ++ks, ++it) {
        const int s = it % a.stages;
        mbar_wait(full0 + 8 * s, (it / a.stages) & 1);
        const uint32_t sa = base + s * a.stage_bytes, sb = sa + SLABS * a.a_bytes;
        if (PROMOTE && a.epi.promote) {
          float part[2][N / 2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) part[r][i] = 0.f;
          conv_issue<N, NDY>(part, sa, sb, a, wg);
          mbar_arrive(empty0 + 8 * s);
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int i = 0; i < N / 2; ++i) acc[r][i] += part[r][i];
        } else {
          conv_issue<N, NDY>(acc, sa, sb, a, wg);
          mbar_arrive(empty0 + 8 * s);
        }
      }
      conv_epilogue<N>(a, acc, p, ty, tx, split, s_gn, s_out);
    }
  }
}

// ----------------------------------------------------------------- wgrad

struct WgradArgs {
  int planes;        // planes reduced over
  int src_planes;    // planes of the A source (the stride of its shifted copies)
  int CA, CB;        // channels per plane of the A source (M) and of the B source (= N)
  int H, W;
  int mrows;         // A rows stored per tap
  int tiles_x, tiles_y, items;
  int stages;
  uint32_t stage_bytes;
  float* part;       // [gridDim.y slots][TAPS][mrows][N]
};

template <int N, int TAPS>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             const WgradArgs a) {
  constexpr int SLABS = TAPS == 9 ? WG_ROWS + 2 : WG_ROWS;
  constexpr int NDX = TAPS == 9 ? 3 : 1, NDY = NDX;
  constexpr uint32_t A_SLAB = 64 * 128, B_SLAB = N * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + a.stages * a.stage_bytes, empty0 = full0 + 8 * a.stages;
  const int dx = blockIdx.x % NDX, mt = blockIdx.x / NDX;
  const int slot = blockIdx.y, nslots = gridDim.y;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      int it = 0;
      for (int item = slot; item < a.items; item += nslots, ++it) {
        const int tx = item % a.tiles_x, ty = (item / a.tiles_x) % a.tiles_y;
        const int p = item / (a.tiles_x * a.tiles_y);
        const int s = it % a.stages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((it / a.stages) & 1) ^ 1);
        mbar_expect_tx(full, SLABS * A_SLAB + WG_ROWS * B_SLAB);
        const uint32_t sa = base + s * a.stage_bytes, sb = sa + SLABS * A_SLAB;
        const int x = tx * TW, y = ty * WG_ROWS;
        const int ch = ((TAPS == 9 ? dx * a.src_planes : 0) + p) * a.CA + mt * 64;
        for (int j = 0; j < SLABS; ++j)
          tma_load_3d(sa + j * A_SLAB, &ma, x, y + j - (TAPS == 9 ? 1 : 0), ch, full);
        for (int r = 0; r < WG_ROWS; ++r)
          tma_load_3d(sb + r * B_SLAB, &mb, x, y + r, p * a.CB, full);
      }
    }
  } else {
    float acc[NDY][N / 2];
#pragma unroll
    for (int d = 0; d < NDY; ++d)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[d][i] = 0.f;
    int it = 0;
    for (int item = slot; item < a.items; item += nslots, ++it) {
      const int s = it % a.stages;
      mbar_wait(full0 + 8 * s, (it / a.stages) & 1);
      const uint32_t sa = base + s * a.stage_bytes, sb = sa + SLABS * A_SLAB;
#pragma unroll
      for (int d = 0; d < NDY; ++d) fence_regs(acc[d]);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < WG_ROWS; ++r)
#pragma unroll
        for (int dy = 0; dy < NDY; ++dy)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma<N, 0>(acc[dy], kmajor_desc<128>(sa + (r + dy) * A_SLAB + kk * 32),
                      kmajor_desc<128>(sb + r * B_SLAB + kk * 32));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int d = 0; d < NDY; ++d) fence_regs(acc[d]);
      mbar_arrive(empty0 + 8 * s);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int dy = 0; dy < NDY; ++dy) {
      const int tap = TAPS == 9 ? dy * 3 + dx : 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int m = mt * 64 + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (m < a.mrows)
          a.part[(((size_t)slot * TAPS + tap) * a.mrows + m) * N + n] = acc[dy][i];
      }
    }
  }
}

// ------------------------------------------------------------------ host

// A 3D map over bf16 planes: X columns at a row pitch of `pitch` elements
// (a multiple of 8), H rows, `cp` channels x planes; boxes of 64 columns x
// 1 row x box_c channels, 128-byte swizzle. Columns past X, rows outside
// [0, H) and channels past cp arrive as zeros.
inline bool plane_map(CUtensorMap* map, const void* base, int X, int H, long long cp, int pitch,
                      int box_c) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)X, (cuuint64_t)H, (cuuint64_t)cp};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2, (cuuint64_t)pitch * 2 * H};
  const cuuint32_t box[3] = {(cuuint32_t)TW, 1, (cuuint32_t)box_c};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

inline int chunk_of(int c) { return c % 64 == 0 ? 64 : c % 32 == 0 ? 32 : 16; }

// A bf16 source plane set: planes x C channels of H x W at row pitch
// `pitch`; `shifted`: three such sets one after another, the source moved
// by -1, 0 and +1 columns (shifted_source), as the 3x3 kernels read it.
struct Planes {
  const bf16* ptr;
  int planes, C, H, W, pitch;
  bool shifted;
};

// The conv kernel over `in` with weights w: TAPS = 9, bf16 [9][wrows][C]
// (tap ky * 3 + kx; the 3x3 convolution, padding 1; its first N rows, or
// with wrows 0 all of [9][N][C]); TAPS = 1, bf16 [nsplit][N][C]. Returns a
// CUDA error code.
template <int N, int TAPS>
int conv(const Planes& in, const bf16* w, int nsplit, const Epi& epi, cudaStream_t st,
         int wrows = 0) {
  constexpr int SLABS = TAPS == 9 ? CONV_ROWS + 2 : CONV_ROWS;
  constexpr int NB = TAPS == 9 ? 3 : 1;
  ConvArgs a;
  a.planes = in.planes;
  a.C = in.C;
  a.H = in.H;
  a.W = in.W;
  a.kc = chunk_of(in.C);
  a.nchunks = in.C / a.kc;
  a.nsplit = nsplit;
  a.tiles_x = (in.W + TW - 1) / TW;
  a.tiles_y = (in.H + CONV_ROWS - 1) / CONV_ROWS;
  a.items = in.planes * a.tiles_x * a.tiles_y * nsplit;
  a.a_bytes = a.kc * 128;
  a.b_bytes = ((uint32_t)N * a.kc * 2 + 1023) & ~1023u;
  a.stage_bytes = SLABS * a.a_bytes + NB * a.b_bytes;
  const int tail = 16 * 4 + 8 * 8 * 2 * 4;   // barriers (up to 4 stages) and GroupNorm sums
  const int lines =
      staged_out(N, epi.mode) ? 2 * 2 * N * OUT_PITCH * (epi.add != nullptr ? 4 : 2) : 0;
  const int ring = SMEM_MAX - 1024 - tail - lines;
  a.stages = (ring < SMEM_BUDGET - 1024 - tail ? ring : SMEM_BUDGET - 1024 - tail) /
             (int)a.stage_bytes;
  a.stages = a.stages > 4 ? 4 : a.stages;
  a.epi = epi;
  if (a.epi.cstride == 0) a.epi.cstride = N;
  if (a.stages < 2 || in.C % 16 || in.shifted != (TAPS == 9) ||
      (a.epi.gn_part != nullptr && (N % 16 || a.epi.cstride % 16)))
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + a.stages * (int)a.stage_bytes + tail + lines;
  auto kernel = conv_kernel<N, TAPS>;
  // a runtime call first: it makes the context current in this thread,
  // which the tensor-map encode needs
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ma, mb;
  if (!plane_map(&ma, in.ptr, in.W, in.H, (long long)(TAPS == 9 ? 3 : 1) * in.planes * in.C,
                 in.pitch, a.kc) ||
      !tensor_map_3d(&mb, w, in.C, N, TAPS == 9 ? 9 : nsplit, in.C,
                     (long long)(wrows > 0 ? wrows : N) * in.C, a.kc, N))
    return (int)cudaErrorInvalidValue;
  const int grid = a.items < sm_count() ? a.items : sm_count();
  kernel<<<grid, CONV_THREADS, smem, st>>>(ma, mb, a);
  return (int)cudaGetLastError();
}

// Weight-gradient partials of the wgrad kernel: part [slots][TAPS][mrows]
// [N] with A = `in` (rows: its channels) and B = g's channels n0 .. n0 + N
// (where g has fewer, the columns past its channels read the next planes'
// and are to be dropped: the head's gradient, 1 channel, runs at N = 16;
// wgrad_cols), reduced over the first `planes` planes; `slots` is what the
// caller sized part for (wgrad_slots). Returns a CUDA error code.
template <int N, int TAPS>
int wgrad(const Planes& in, const Planes& g, int planes, int mrows, int slots, float* part,
          cudaStream_t st, int n0 = 0) {
  constexpr int SLABS = TAPS == 9 ? WG_ROWS + 2 : WG_ROWS;
  WgradArgs a;
  a.planes = planes;
  a.src_planes = in.planes;
  a.CA = in.C;
  a.CB = g.C;
  a.H = g.H;
  a.W = g.W;
  a.mrows = mrows;
  a.tiles_x = (g.W + TW - 1) / TW;
  a.tiles_y = (g.H + WG_ROWS - 1) / WG_ROWS;
  a.items = planes * a.tiles_x * a.tiles_y;
  a.stage_bytes = SLABS * 64 * 128 + WG_ROWS * N * 128;
  a.stages = (SMEM_BUDGET - 1024 - 64) / (int)a.stage_bytes;
  a.stages = a.stages > 4 ? 4 : a.stages;
  a.part = part;
  if (n0 < 0 || n0 >= g.C || a.stages < 2 || in.shifted != (TAPS == 9) || g.shifted)
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + a.stages * (int)a.stage_bytes + 64;
  auto kernel = wgrad_kernel<N, TAPS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ma, mb;
  if (!plane_map(&ma, in.ptr, in.W, in.H, (long long)(TAPS == 9 ? 3 : 1) * in.planes * in.C,
                 in.pitch, 64) ||
      !plane_map(&mb, g.ptr + (size_t)n0 * g.H * g.pitch, g.W, g.H, (long long)g.planes * g.C,
                 g.pitch, N))
    return (int)cudaErrorInvalidValue;
  dim3 grid((TAPS == 9 ? 3 : 1) * ((mrows + 63) / 64), slots);
  kernel<<<grid, WG_THREADS, smem, st>>>(ma, mb, a);
  return (int)cudaGetLastError();
}

// Slots of a wgrad reduction: about one block per SM over all of them.
inline int wgrad_slots(int taps, int mrows) {
  const int bx = (taps == 9 ? 3 : 1) * ((mrows + 63) / 64);
  return (sm_count() + bx - 1) / bx;
}

// dst[d][row][x] = src[row][x + d - 1] (0 outside [0, W), and up to the
// pitch) for d = 0, 1, 2 (d = 1 alone with `copies` = 1): rows of W
// elements moved by -1, 0 and +1 columns at a pitch that TMA takes. A
// thread writes 8 columns of each copy (16-byte stores).
__global__ void shift_copy_kernel(const bf16* __restrict__ src, size_t rows, int W, int pitch,
                                  int copies, bf16* __restrict__ dst) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;   // 8 columns
  const size_t n = rows * pitch;
  if (i * 8 >= n) return;
  const size_t row = i * 8 / pitch;
  const int x0 = (int)(i * 8 % pitch);
  const bf16* r = src + row * W;
  const bf16 zero = __float2bfloat16(0.f);
  bf16 v[10];   // columns x0 - 1 .. x0 + 8
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const int x = x0 + j - 1;
    v[j] = x >= 0 && x < W ? r[x] : zero;
  }
  for (int d = copies == 1 ? 1 : 0; d < (copies == 1 ? 2 : 3); ++d) {
    uint4 o;
    bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = v[j + d];
    *reinterpret_cast<uint4*>(dst + (copies == 1 ? 0 : d * n) + i * 8) = o;
  }
}

inline int tma_pitch(int W) { return (W + 7) / 8 * 8; }

// `p` as the A source of a 3x3 kernel: its three column-shifted copies in
// `scratch` (3 planes C H tma_pitch(W) elements). TMA takes a box only at
// a column that is a whole number of 16-byte units into the row (a box at
// x0 - 1 is an illegal instruction with the 128-byte swizzle), so the
// shift by one pixel is made here, once per source, not per box.
inline Planes shifted_source(const bf16* p, int planes, int C, int H, int W, bf16* scratch,
                             cudaStream_t st) {
  const int pitch = tma_pitch(W);
  const size_t rows = (size_t)planes * C * H;
  shift_copy_kernel<<<(unsigned)((rows * pitch / 8 + 255) / 256), 256, 0, st>>>(p, rows, W,
                                                                                pitch, 3, scratch);
  return Planes{scratch, planes, C, H, W, pitch, true};
}

// The unshifted planes of a shifted source.
inline Planes center(const Planes& s) {
  return Planes{s.ptr + (size_t)s.planes * s.C * s.H * s.pitch, s.planes, s.C, s.H, s.W, s.pitch,
                false};
}

// `p` as an unshifted TMA source: itself when its width is a multiple of
// 8, else a copy at the next such pitch in `scratch`.
inline Planes tma_source(const bf16* p, int planes, int C, int H, int W, bf16* scratch,
                         cudaStream_t st) {
  if (W % 8 == 0) return Planes{p, planes, C, H, W, W, false};
  const int pitch = tma_pitch(W);
  const size_t rows = (size_t)planes * C * H;
  shift_copy_kernel<<<(unsigned)((rows * pitch / 8 + 255) / 256), 256, 0, st>>>(p, rows, W,
                                                                                pitch, 1, scratch);
  return Planes{scratch, planes, C, H, W, pitch, false};
}

}  // namespace igemm
