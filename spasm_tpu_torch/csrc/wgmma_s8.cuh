// Warpgroup matrix multiply-accumulate on int8 operands (Hopper, sm_90a):
// D (64 x N, int32 registers) += A (64 x 32, shared memory) @ B (32 x N,
// shared memory, stored N x 32: both operands K-major, the only layout
// wgmma takes for 8-bit types).  Without .satfinite: the callers bound
// their accumulators themselves, and a saturated sum would be wrong.
//
// A thread t of the warpgroup (warp w = t / 32, lane l = t % 32) holds, in
// d[4 * j + 2 * h + e], the element at row 16 * w + l / 4 + 8 * h and
// column 8 * j + 2 * (l % 4) + e of D.
#pragma once
#include <stdint.h>

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, stored with the 128-byte swizzle (the 16-byte chunk c of row r
// lies at chunk c ^ (r % 8)); the tile starts on a 1024-byte boundary.
// Eight rows are 1024 bytes apart (stride offset); the leading offset is
// unused for swizzled K-major operands.  A step of 32 bytes along k inside
// the 128-byte row adds 2 to the address field.
__device__ __forceinline__ uint64_t wgmma_desc_k128(uint32_t smem_addr) {
    return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4)
        | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d = (keep ? d : 0) + A @ B, one m64nNk32 instruction; N / 2 accumulator
// registers a thread.  Clearing through keep = 0 (the instruction's scale-d)
// leaves the accumulators untouched by any other instruction while wgmma
// groups are in flight, which ptxas would answer by serializing them.
template <int N> struct MmaS8;

template <> struct MmaS8<32> {
    static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                                 uint64_t db, int keep) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
            : "l"(da), "l"(db), "r"(keep));
    }
};

template <> struct MmaS8<64> {
    static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                                 uint64_t db, int keep) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
            : "l"(da), "l"(db), "r"(keep));
    }
};

template <> struct MmaS8<128> {
    static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                                 uint64_t db, int keep) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11, %12, %13, %14, %15,"
            " %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31,"
            " %32, %33, %34, %35, %36, %37, %38, %39,"
            " %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55,"
            " %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
            : "l"(da), "l"(db), "r"(keep));
    }
};
