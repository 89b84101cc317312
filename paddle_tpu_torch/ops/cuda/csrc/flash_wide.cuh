// The 2-byte flash kernels at head widths 192 and 256 on wgmma and TMA,
// built only into the wide libraries (FLASH_WIDE, _build.py's VARIANTS):
// the forward body fwd_wg below, which K1a's flash_fwd_wg
// (flash_attention.cu) and K1c's short_fwd_wg (flash_short.cu) launch,
// and the pieces K1d's short_bwd_wg (flash_short.cu) shares with it.
//
// Replaces, at these widths, the 4-warp mma.sync body fwd_mma
// (flash_common.cuh): with its 64 x D accumulator (96 or 128 f32 a
// thread) beside the scores it ran at 255 registers with spills, one
// block an SM (five 64-row tiles, 160 KB at D 256), its copies issued by
// the warps that multiply, and mma.sync, which does not reach the tensor
// cores' rate. The forward is a product loop: bound by operations at
// GPT-2's causal 1024 keys, near the balance point at BERT phase 2's 512.
//
// A block is two warpgroups (256 threads) on a 128-row q tile, rows 64 g
// .. 64 g + 63 for warpgroup g:
// - S = Q K^T by wgmma m64n64k16 from shared memory, then the online
//   softmax in f32 on the accumulator (its layout, warp by warp and 8
//   columns at a time, is the m16n8 C layout, so mask_tile, keep_frag,
//   frag_row and frag_col apply as they are), and O += P V by wgmma
//   m64nDk16 with P from registers (the m16n8k16 A fragments of the
//   accumulator, hi + lo as acc_to_a2 rounds them; one term in K1c's f16
//   form, P_ONE) and V from shared memory through the transposed
//   (MN-major) descriptor. O stays in registers: 96 or 128 f32 a thread.
// - The copies are TMA (boxes of 64 x 64 with the 128-byte swizzle, zeros
//   past the sequence end): the q tile once, then each kv tile's K and V
//   into a ring of kWgStages stages. Warpgroup 1's first warp issues them
//   (with a key mask its lanes also copy the tile's 64 bias values beside
//   it) and refills a stage once every consumer warp has released it (an
//   mbarrier each way). A producer warpgroup with setmaxnreg (24
//   registers for it, 240 for the consumers) was built first: ptxas
//   (CUDA 12.8) still allocated the consumers at the 168 registers a
//   384-thread block starts with and spilled 0.4-5.7 KB a thread in every
//   instantiation (C7512: wgmma serialized), as K2's fused_xent.cu forms
//   found with a ninth warp; at 256 threads a thread may hold 255.
// The numerics are fwd_mma's: scale, key bias and -inf masks in f32,
// exp2 by ex2.approx, l over the undropped P, Philox dropout by element
// coordinates, out = O / l, lse = m + log(l). Ragged lengths: TMA
// zero-fills rows past Lq and Lk, columns past Lk score -inf, rows past
// Lq are not written. Causal blocks start longest first and warpgroup 0
// stops a kv tile before warpgroup 1 (its rows end 64 sooner). A masked
// block skips the dead kv tiles (scan_live_tiles, next_live) where that
// is exact, as fwd_mma does.
//
// Shared memory: Q 2 x 64 x D and two stages of K and V, 2-byte: 192 KB
// at D 256, 144 KB at D 192, one block an SM.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWgThreads = 256;      // two warpgroups: 255 registers a thread
constexpr int kWgStages = 2;         // the forward's K / V ring
constexpr uint32_t kBlk = kTile * 128;   // 64 rows x 64 columns, 2-byte

// bytes of a 64-row tile of width D: D / 64 blocks of 64 rows x 128 bytes
template <int D>
constexpr uint32_t kTileBytes = (D / 64) * kBlk;

// wgmma operand descriptors of a 64-row tile at t (blocks of 64 columns,
// 1024-byte aligned, 128-byte swizzle). K-major: the contraction runs
// along the rows (depth step kk: block kk / 4, 32 bytes a step inside it)
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int kk) {
  return wg_desc(t + (kk >> 2) * kBlk + 32 * (kk & 3), 16, 1024);
}

// MN-major (transposed): the contraction runs down the rows (depth step
// kk: rows 16 kk ..), the blocks kBlk apart along the other axis
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int kk) {
  return wg_desc(t + kk * 2048, kBlk, 1024);
}

// The same descriptors as a base made where they are used plus each
// step's offset (the start address field counts 16 bytes): a descriptor
// of a tile that stays put across a loop is otherwise computed once and
// held in two registers for the whole loop, one for every depth step,
// which at D = 256 pushed K1d's backward into local memory.
struct WgDesc {
  uint64_t base;
  __device__ __forceinline__ explicit WgDesc(uint64_t d) : base(d) {
    asm volatile("" : "+l"(base));
  }
  __device__ __forceinline__ uint64_t k(int kk) const {   // desc_k
    return base + (uint64_t)(((kk >> 2) * kBlk + 32 * (kk & 3)) >> 4);
  }
  __device__ __forceinline__ uint64_t mn(int kk) const {  // desc_mn
    return base + (uint64_t)((kk * 2048) >> 4);
  }
};

__device__ __forceinline__ WgDesc wg_k(uint32_t t) {
  return WgDesc(wg_desc(t, 16, 1024));
}

__device__ __forceinline__ WgDesc wg_mn(uint32_t t) {
  return WgDesc(wg_desc(t, kBlk, 1024));
}

// d (64 x 64) = A B (FRESH: d's old values are not read, write-only
// operands) or += A B, A and B from shared memory; TA, TB: 1 where the
// operand is MN-major (transposed)
template <class T, int TA, int TB, bool FRESH>
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t a,
                                        uint64_t b) {
  if constexpr (FRESH) {
    if constexpr (kIsHalf<T>)
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, %32, %33, p, 1, 1, %35, %36; }"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
            "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
            "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
            "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
            "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
            "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
            "=f"(d[30]), "=f"(d[31])
          : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
    else
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, %32, %33, p, 1, 1, %35, %36; }"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
            "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
            "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
            "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
            "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
            "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
            "=f"(d[30]), "=f"(d[31])
          : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
  } else {
    if constexpr (kIsHalf<T>)
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, %32, %33, p, 1, 1, %35, %36; }"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
    else
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, %32, %33, p, 1, 1, %35, %36; }"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
  }
}

// d (64 x 64) = or += A B, A from registers (the m16n8k16 A fragment
// of the warp's 16 rows), B MN-major from shared memory
template <class T, bool FRESH>
__device__ __forceinline__ void wg_rs64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (FRESH) {
    if constexpr (kIsHalf<T>)
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38; }"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
            "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
            "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
            "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
            "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
            "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
            "=f"(d[30]), "=f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0), "n"(1));
    else
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38; }"
          : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
            "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
            "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
            "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
            "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
            "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
            "=f"(d[30]), "=f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0), "n"(1));
  } else {
    if constexpr (kIsHalf<T>)
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38; }"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
    else
      asm volatile(
          "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
          "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
          "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
          "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38; }"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
            "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
            "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
            "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
  }
}

// d (64 x 192) += A B, A and B MN-major from shared memory (P^T dO,
// dS^T Q)
template <class T>
__device__ __forceinline__ void wg_ss_t192(float (&d)[96], uint64_t a,
                                          uint64_t b) {
  if constexpr (kIsHalf<T>)
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %98, 0; "
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95}, %96, %97, p, 1, 1, %99, %100; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(1), "n"(1));
  else
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %98, 0; "
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95}, %96, %97, p, 1, 1, %99, %100; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(1), "n"(1));
}

// d (64 x 192) += A B, A from registers, B MN-major from shared memory
// (P V)
template <class T>
__device__ __forceinline__ void wg_rs_t192(float (&d)[96],
                                          const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<T>)
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %101, 0; "
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95}, {%96, %97, %98, %99}, %100, p, 1, 1, %102; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
  else
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %101, 0; "
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95}, {%96, %97, %98, %99}, %100, p, 1, 1, %102; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
}

// d (64 x 256) += A B, A and B MN-major from shared memory (P^T dO,
// dS^T Q)
template <class T>
__device__ __forceinline__ void wg_ss_t256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  if constexpr (kIsHalf<T>)
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %130, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
        "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, "
        "%129, p, 1, 1, %131, %132; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(1), "n"(1));
  else
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %130, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
        "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, "
        "%129, p, 1, 1, %131, %132; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(1), "n"(1));
}

// d (64 x 256) += A B, A from registers, B MN-major from shared memory
// (P V)
template <class T>
__device__ __forceinline__ void wg_rs_t256(float (&d)[128],
                                          const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<T>)
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
        "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
  else
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
        "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
        "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
        "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134; }"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(1));
}


// d (64 x D) += A B for the head widths: A from registers (P V), or both
// MN-major from shared memory (P^T dO, dS^T Q)
template <class T, int D>
__device__ __forceinline__ void wg_rs_t(float (&d)[D / 2],
                                        const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 256)
    wg_rs_t256<T>(d, a, b);
  else
    wg_rs_t192<T>(d, a, b);
}

template <class T, int D>
__device__ __forceinline__ void wg_ss_t(float (&d)[D / 2], uint64_t a,
                                        uint64_t b) {
  if constexpr (D == 256)
    wg_ss_t256<T>(d, a, b);
  else
    wg_ss_t192<T>(d, a, b);
}

// a (B, L, H, D) 2-byte array read in boxes of 64 columns x one head x
// 64 rows, 128-byte swizzle, zeros past L; false where
// cuTensorMapEncodeTiled is missing or refuses the map
inline bool bhld_map(CUtensorMap* map, const void* base, int B, int L,
                     int H, int D, bool half) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, step[4] = {1, 1, 1, 1};
  return encode(map, half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows l0 .. l0 + 63 of head h of batch entry b, all D columns, into the
// tile at dst, completing on bar
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int b, int h, int l0, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    tma_box4(dst + cb * kBlk, map, 64 * cb, h, l0, b, bar);
}

// the forward's arguments: q (B, Lq, H, D), k and v (B, Lk, H, D)
template <typename T>
struct WideFwd {
  CUtensorMap q, k, v;
  T* out;
  float* lse;
  Args a;
};

// Q (two 64-row halves), the K and V stages, a stage's 64 bias values
// each, the mbarriers (q, full and empty a stage), the first live key and
// the live-tile bits (one a kv tile)
template <int D>
inline size_t fwd_wg_smem(int Lk) {
  const size_t words = ((Lk + kTile - 1) / kTile + 31) / 32;
  return (size_t)(2 + 2 * kWgStages) * kTileBytes<D> +
         (size_t)kWgStages * kTile * 4 + (1 + 2 * kWgStages) * 8 + 4 +
         words * 4;
}

// kv tile t's K and V (TMA, by lane 0) and, MASKED, its 64 bias values (0
// past Lk, by the warp's lanes) into stage s, completing on its full
// mbarrier
template <int D, bool MASKED, typename T>
__device__ __forceinline__ void fwd_fill(const WideFwd<T>& p, uint32_t Ks,
                                         uint32_t Vs, float* bias_s,
                                         uint32_t full, int t, int s, int b,
                                         int h, int lane) {
  constexpr uint32_t TB = kTileBytes<D>;
  const uint32_t bar = full + 8 * s;
  if (lane == 0) {
    mbar_expect(bar, 2 * TB);
    tma_tile<D>(Ks + s * TB, &p.k, b, h, t * kTile, bar);
    tma_tile<D>(Vs + s * TB, &p.v, b, h, t * kTile, bar);
  }
  if constexpr (MASKED) {
    const Args& a = p.a;
    for (int c = lane; c < kTile; c += 32) {
      const int col = t * kTile + c;
      bias_s[s * kTile + c] =
          col < a.Lk ? a.bias[(int64_t)b * a.Lk + col] : 0.0f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// out and lse of the 128-row q tile qt of (b, h) = blockIdx.y; MASKED:
// the (B, Lk) key bias and the dead-tile skip, as fwd_mma; P_ONE: P
// enters P V as one term of T (K1c's f16 form), else as hi + lo
template <int D, bool MASKED, typename T, bool P_ONE>
__device__ __forceinline__ void fwd_wg(const WideFwd<T>& p, int qt) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  constexpr uint32_t TB = kTileBytes<D>;
  const Args& a = p.a;
  const uint32_t Qs = smem_u32(smem_wg), Ks = Qs + 2 * TB,
                 Vs = Ks + kWgStages * TB;
  unsigned char* tail = smem_wg + (2 + 2 * kWgStages) * TB;
  float* bias_s = reinterpret_cast<float*>(tail);      // [stage][64]
  const uint32_t qbar = smem_u32(tail + kWgStages * kTile * 4),
                 full = qbar + 8, empty = full + 8 * kWgStages;
  int* first = reinterpret_cast<int*>(tail + kWgStages * kTile * 4 +
                                      (1 + 2 * kWgStages) * 8);
  uint32_t* live = reinterpret_cast<uint32_t*>(first + 1);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31,
            w = (tid >> 5) & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * 2 * kTile;
  const int nkv = kv_tiles_for(a, q0 + kTile);     // its last row's
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + 8 * s, MASKED ? 2 : 1);     // + the bias copy
      mbar_init(empty + 8 * s, 8);                 // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool skip =
      MASKED && scan_live_tiles<kWgThreads>(live, first, a, b, q0);
  auto after = [&](int t) { return skip ? next_live(live, t, nkv) : t + 1; };
  // warpgroup 1's first warp issues the copies: the q tile, then kv tile
  // tf into each stage, and later each refill
  const bool filler = wg == 1 && w == 0;
  int tf = after(-1);
  if (filler) {
    if (lane == 0) {
      mbar_expect(qbar, 2 * TB);
      tma_tile<D>(Qs, &p.q, b, h, q0, qbar);
      tma_tile<D>(Qs + TB, &p.q, b, h, q0 + kTile, qbar);
    }
    for (int s = 0; s < kWgStages && tf < nkv; ++s, tf = after(tf))
      fwd_fill<D, MASKED>(p, Ks, Vs, bias_s, full, tf, s, b, h, lane);
  }

  const int row0 = q0 + kTile * wg + 16 * w;
  const int nkv_g = kv_tiles_for(a, q0 + kTile * wg);   // causal: its rows'
  const uint32_t Qg = Qs + wg * TB;
  const bool drop = a.inv != 1.0f;
  float o[D / 2], m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
  ws_wait(qbar, 0);
  int it = 0;
  for (int t = after(-1); t < nkv_g; t = after(t), ++it) {
    const int s = it % kWgStages, kv0 = t * kTile;
    const uint32_t Kt = Ks + s * TB, Vt = Vs + s * TB;
    ws_wait(full + 8 * s, (uint32_t)(it / kWgStages) & 1u);
    float sc[8][4];
    float(&sf)[32] = reinterpret_cast<float(&)[32]>(sc);
    wg_fence();
    wg_ss64<T, 0, 0, true>(sf, desc_k(Qg, 0), desc_k(Kt, 0));   // S = Q K^T
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wg_ss64<T, 0, 0, false>(sf, desc_k(Qg, kk), desc_k(Kt, kk));
    wg_commit();
    wg_wait<0>();
    fence_operands(sf);
    // scale, add the key bias and mask in f32; the online softmax of the
    // thread's two rows (fwd_mma's arithmetic)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] *= a.scale;
    if constexpr (MASKED) {
      const float* bt = bias_s + s * kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 bb =
            *reinterpret_cast<const float2*>(bt + frag_col(lane, i, 0));
        sc[i][0] += bb.x;
        sc[i][1] += bb.y;
        sc[i][2] += bb.x;
        sc[i][3] += bb.y;
      }
    }
    mask_tile(sc, a, row0, kv0, lane, -INFINITY);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[i][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    const uint32_t keep = drop ? keep_frag(a, bh, row0, kv0, lane) : ~0u;
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2_ftz((sc[i][e] - m[e >> 1]) * kLog2e);
        rs[e >> 1] += pv;
        sc[i][e] =
            !drop ? pv : ((keep >> (4 * i + e)) & 1u) ? pv * a.inv : 0.0f;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
    // P as the A fragments of P V: hi + lo, or one term (P_ONE)
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (P_ONE) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ph[kk][j] = pack_pair<T>(sc[2 * kk + (j >> 1)][2 * (j & 1)],
                                   sc[2 * kk + (j >> 1)][2 * (j & 1) + 1]);
      } else {
        acc_to_a2<T>(ph[kk], pl[kk], sc, kk);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j & 3) >> 1];
    fence_operands(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                  // O += P V
      wg_rs_t<T, D>(o, ph[kk], desc_mn(Vt, kk));
      if constexpr (!P_ONE) wg_rs_t<T, D>(o, pl[kk], desc_mn(Vt, kk));
    }
    wg_commit();
    wg_wait<0>();
    fence_operands(o);
    if (lane == 0) mbar_arrive(empty + 8 * s);       // the stage is free
    if (filler && tf < nkv) {   // every consumer warp released it: refill
      if (lane == 0) ws_wait(empty + 8 * s, (uint32_t)(it / kWgStages) & 1u);
      __syncwarp();
      fwd_fill<D, MASKED>(p, Ks, Vs, bias_s, full, tf, s, b, h, lane);
      tf = after(tf);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lc = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = row0 + frag_row(lane, 2 * r);
    if ((lane & 3) == 0 && row < a.Lq)
      p.lse[(int64_t)bh * a.Lq + row] = m[r] + logf(lc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] /= lc;
      o[4 * j + 2 * r + 1] /= lc;
    }
  }
  store_acc<D>(p.out, reinterpret_cast<float(&)[D / 8][4]>(o), a, b, h, row0,
               a.Lq, 1.0f, lane);
}

// the forward's launch: tensor maps of q, k, v, grid (128-row q tiles,
// B * H), 384 threads; kern is flash_fwd_wg or short_fwd_wg
template <int D, typename T, typename K>
int launch_fwd_wg(K kern, const void* q, const void* k, const void* v,
                  void* out, float* lse, const Args& a, cudaStream_t st) {
  WideFwd<T> p;
  const bool half = kIsHalf<T>;
  if (!bhld_map(&p.q, q, a.B, a.Lq, a.H, D, half) ||
      !bhld_map(&p.k, k, a.B, a.Lk, a.H, D, half) ||
      !bhld_map(&p.v, v, a.B, a.Lk, a.H, D, half))
    return (int)cudaErrorInvalidValue;
  p.out = (T*)out;
  p.lse = lse;
  p.a = a;
  const size_t smem = fwd_wg_smem<D>(a.Lk);
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Lq + 2 * kTile - 1) / (2 * kTile), a.B * a.H);
  kern<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
