// wgmma building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) for Hopper (sm_90a):
// shared-memory descriptors in the 128-byte swizzle, the cp.async tile
// copy that writes that swizzle (by one or two warpgroups), and the
// m64n64 / m64n128 / m64n192 (and, as two m64n128, m64n256) bf16 products
// with A from shared memory (_ss; _ss_tt with both operands MN-major) or
// from registers (_rs).
//
// Tile layout: a 64-row tile of a (rows, D) bf16 matrix is DP / 64
// column blocks of 64 values (8 KB each, DP = D padded to a multiple of
// 64); 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its 128-byte
// row. Read K-major (D contiguous, the reduction over D): descriptor LBO
// 16, SBO 1024 B between 8-row groups, the k16 step advancing 32 B within
// a row and 8 KB across column blocks. Read MN-major (the reduction over
// the tile's rows, transpose flag set): LBO 8 KB between column blocks,
// SBO 1024 B between 8-row groups, the k16 step advancing 2 KB (16 rows).
// An m64nN f32 accumulator fragment holds, in thread t of warp w, float
// 4 n + 2 h + e at row 16 w + t / 4 + 8 h, column 8 n + 2 (t % 4) + e; the
// k16 A fragments of the next product over those columns are floats
// 8 kk + 2 r and 8 kk + 2 r + 1, r < 4, packed as bf16 pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int BR = 64;       // query rows per block: one wgmma M
constexpr int BN = 64;       // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across the async mma
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy rows [r0, r0 + 64) of a (rows, D) bf16 matrix into a 64 x DP tile
// in the 128-byte swizzle, column blocks of 64 values (8 KB each), by NT
// threads (one or two warpgroups); rows at or past nrows and columns at
// or past D are zero-filled.
template <int D, int DP, int NT = 128>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g, int r0,
                                          int nrows) {
  constexpr int CPR = DP / 8;  // 16-byte chunks a padded row
  if constexpr (NT % CPR != 0) {
    // a row's chunks do not divide the threads (DP = 192: 24 chunks): thread
    // t copies the tile's chunks t, t + NT, ... in row-major order
    static_assert(64 * CPR % NT == 0, "the tile must be whole passes of NT chunks");
#pragma unroll
    for (int u = 0; u < 64 * CPR / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      const int r = i / CPR, cc = i % CPR;
      const bool in = cc * 8 < D && r0 + r < nrows;
      const __nv_bfloat16* src = in ? g + (size_t)(r0 + r) * D + cc * 8 : g;
      const uint32_t a = dst + (cc >> 3) * (64 * 128) + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
                   "r"(in ? 16 : 0)
                   : "memory");
    }
    return;
  }
  // thread t copies chunk cc = t % CPR of rows t / CPR + (NT / CPR) u; where
  // NT / CPR is a multiple of 8 (DP <= 128) every pass has the same row % 8,
  // so the swizzled offset folds to one, else (DP = 256 by one warpgroup)
  // it alternates
  const int cc = threadIdx.x % CPR, rr = threadIdx.x / CPR;
  const bool col = cc * 8 < D;
#pragma unroll
  for (int u = 0; u < 64 * CPR / NT; ++u) {
    const int r = rr + u * (NT / CPR);
    const bool in = col && r0 + r < nrows;
    const __nv_bfloat16* src = in ? g + (size_t)(r0 + r) * D + cc * 8 : g;
    const int r8 = (NT / CPR) % 8 == 0 ? rr & 7 : r & 7;  // r % 8
    const uint32_t a = dst + (cc >> 3) * (64 * 128) + r * 128 + (((cc & 7) ^ r8) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
  }
}

// d (m64n64 f32 fragment) += A (smem, K-major) x B (smem, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64 f32 fragment) += A (registers: four bf16x2) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n128 f32 fragment) += A (registers: four bf16x2) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n192 f32 fragment) += A (registers: four bf16x2) x B (smem, MN-major):
// MLA's D = 192, three 64-wide column blocks of B in one product
__device__ __forceinline__ void wgmma_m64n192k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (m64n64 f32 fragment) (+)= A (smem, MN-major) x B (smem, MN-major):
// both operands transposed, as dQ = dS K reads dS^T and K
__device__ __forceinline__ void wgmma_m64n64k16_ss_tt(float* d, uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n128 f32 fragment) (+)= A (smem, MN-major) x B (smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss_tt(float* d, uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int DP>
__device__ __forceinline__ void pv(float* o, const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<128>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<192>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_m64n192k16_rs(o, a, db, 1);
}
// D = 256: two m64n128 products over B's column halves (two 8 KB column
// blocks each: the descriptor's address, in 16-byte units, moves 16 KB);
// the m64n256 fragment's columns 128.. are floats 64.. of a thread
template <>
__device__ __forceinline__ void pv<256>(float* o, const uint32_t* a, uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db, 1);
  wgmma_m64n128k16_rs(o + 64, a, db + ((2 * 64 * 128) >> 4), 1);
}

// d (m64nDP) (+)= A x B, both from shared memory and both MN-major
template <int DP>
__device__ __forceinline__ void mm_tt(float* d, uint64_t da, uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void mm_tt<64>(float* d, uint64_t da, uint64_t db, int accumulate) {
  wgmma_m64n64k16_ss_tt(d, da, db, accumulate);
}
template <>
__device__ __forceinline__ void mm_tt<128>(float* d, uint64_t da, uint64_t db, int accumulate) {
  wgmma_m64n128k16_ss_tt(d, da, db, accumulate);
}

// the padded width and the bytes of a 64-row tile
template <int D> struct Tile {
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int BYTES = 64 * DP * 2;
};

}  // namespace wg
