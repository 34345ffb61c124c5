// K1: exact dense matrix product over GF(p) on the H100's int8 tensor cores.
//
// Replaces spasm_tpu/ops/pallas_matmul.py::_kernel (launched by _pallas_mm,
// wrapped by modmatmul_pallas, which splits the limbs in jnp before the
// kernel).  C = A @ B mod p for balanced int32 A (n, k) and B (k, m), exact
// for every legal p <= 0xFFFFFFFB and any k.  With nl balanced base-256
// limbs x = sum_i x_i 256**i, x_i in [-128, 127],
//
//     A @ B = sum_s D_s * 256**s,   D_s = sum_{i+j=s} A_i @ B_j.
//
// Two kinds of kernel, and the wrapper (ops/cuda_matmul.py) launches
// nothing else:
//
// 1. The split kernels read an int32 operand through its strides and write
//    its nl int8 limb planes, zero-padded to the product's tile multiples,
//    K-major: A as (nl, np, kp), B transposed through a shared-memory tile
//    to (nl, mp, kp), so that both the int32 reads and the int8 writes are
//    coalesced.  wgmma reads 8-bit operands K-major only.  One launch per
//    operand; bytes-bound (4 bytes in, nl out per element).
//
// 2. The product kernel (modmatmul_product.cuh; its instantiations are
//    compiled by modmatmul_lo.cu and modmatmul_hi.cu).  A CTA owns a 128 x
//    BN tile of C: two consumer warpgroups of 64 rows each, and a producer
//    warpgroup that gives its registers away (setmaxnreg).  One producer
//    thread keeps a ring of shared-memory stages full by TMA
//    (cp.async.bulk.tensor completing on the stage's mbarrier), each stage
//    holding the 128 x 128 bytes of every A plane and the BN x 128 bytes of
//    every B plane for one k step of 128, in the 128-byte swizzle the wgmma
//    descriptor names.  (The same ring filled by 16-byte cp.async from the
//    128 producer threads was 1.5x slower at 4096^3 and is not kept.)  The
//    consumers wait on a stage's "full" mbarrier, start nl*nl*4
//    wgmma.mma_async m64nBNk32 s8 x s8 -> s32 (no .satfinite) into 2nl-1
//    register accumulators, one per limb diagonal, keep one stage's group
//    in flight while they start the next, and release the stage through
//    its "empty" mbarrier.
//
//    The accumulators are all the registers can hold (3 x 64 at nl = 2),
//    so there is no running total in registers: |D_s| grows by at most
//    nl * 128 * 128 per unit of k, and before it could pass 2**31 (every
//    kflush of k) the diagonals are folded mod p into C itself, each
//    thread reading back and rewriting its own elements; the last fold is
//    the epilogue: C = C + sum_s (D_s mod p) * (256**s mod p), exact in
//    int64 (modp.cuh).  Up to two limbs the whole weighted sum fits 2**48
//    and takes one reduction without a conversion instruction, because at
//    the main path's k of 128 .. 1000 the epilogue is a large part of a
//    CTA's time.  Nothing but wgmma writes an accumulator (they are
//    cleared through the instruction's scale-d), or ptxas serializes the
//    wgmma groups.  No main-path call is long enough for a fold before the
//    end.  With accumulate, C holds an addend on entry and the first fold
//    reads it: C += A @ B in place, with no elementwise pass after.
//
// Every launch takes an optional one-byte device flag (run): where it
// reads 0, each CTA returns at once.  The dense finish runs its products
// under device predicates (the reference's lax.cond) this way, with no
// host read, inside one CUDA graph.
//
// What bounds it on this card: nl*nl int8 plane products on the tensor
// cores (operations), 4 at the default p = 42013; the bytes of A, B and C
// are 20x below that at 4096^3.  What the kernel reaches is 0.7 of the
// int8 peak at 4096^3: each k stage of a 128 x 128 tile asks the L2 for 64
// KB per 8.4 M multiply-adds, about 7 TB/s over the card at the peak rate.
// BN shrinks with nl (128, 128, 64, 32, 32) so that the 2nl-1 accumulators
// of BN/2 registers stay in the register file without spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modmatmul_product.cuh"

using namespace spasm_k1;

namespace {

// ---------------------------------------------------------- the split

// Limb i of the four values, one byte each (the two's-complement byte of a
// balanced limb is the low byte itself); then the carry step of
// spasm_tpu_torch/ops/modmul.to_limbs: v' = (v >> 8) + (low >> 7), exact
// at the int32 extremes.
__device__ __forceinline__ uint32_t limb_word(int (&v)[4]) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int low = v[e] & 255;
        word |= static_cast<uint32_t>(low) << (8 * e);
        v[e] = (v[e] >> 8) + (low >> 7);
    }
    return word;
}

// x: (r, c) int32 with element strides (sr, sc); out: (nl, rows, cols)
// int8, rows % 8 == 0, cols % 128 == 0, zero outside (r, c).  A thread
// takes four neighbouring columns of one row.  run: as the product's (the
// planes of a skipped product are not needed).
__global__ void __launch_bounds__(256)
split_rows_kernel(const int32_t* __restrict__ x, long long sr, long long sc,
                  int r, int c, int8_t* __restrict__ out, int rows, int cols,
                  int nl, const uint8_t* __restrict__ run) {
    if (run != nullptr && *run == 0) return;
    const int row = blockIdx.x * 8 + threadIdx.y;
    const int col = (blockIdx.y * 32 + threadIdx.x) * 4;
    if (row >= rows || col >= cols) return;
    int v[4] = {0, 0, 0, 0};
    if (row < r && col < c) {
        const int32_t* src = x + row * sr + col * sc;
        if (sc == 1 && col + 3 < c
            && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            const int4 q = __ldg(reinterpret_cast<const int4*>(src));
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (col + e < c) v[e] = __ldg(src + e * sc);
        }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + static_cast<size_t>(row) * cols + col);
    const size_t plane = static_cast<size_t>(rows) * cols / 4;
    for (int i = 0; i < nl; ++i) dst[i * plane] = limb_word(v);
}

// x: (k, m) int32 with element strides (sr, sc); out: (nl, mp, kp) int8,
// the planes of x transposed, mp % 32 == 0, kp % 128 == 0, zero outside
// (m, k).  A CTA takes 128 k x 32 m: a warp reads 32 neighbouring m of one
// k row, the bytes go through shared memory, and a warp writes the 128
// neighbouring k bytes of one m row.
__global__ void __launch_bounds__(256)
split_transpose_kernel(const int32_t* __restrict__ x, long long sr,
                       long long sc, int k, int m, int8_t* __restrict__ out,
                       int mp, int kp, int nl, const uint8_t* __restrict__ run) {
    if (run != nullptr && *run == 0) return;
    // [limb][m][k word]; 33 words a row keep both phases free of bank
    // conflicts
    __shared__ uint32_t tile[5][32][33];
    uint8_t* bytes = reinterpret_cast<uint8_t*>(tile);
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int m0 = blockIdx.x * 32, k0 = blockIdx.y * 128;
    const int mc = m0 + tx;
    for (int kk = ty; kk < 128; kk += 8) {
        const int kr = k0 + kk;
        int v = (kr < k && mc < m) ? __ldg(x + kr * sr + mc * sc) : 0;
        for (int i = 0; i < nl; ++i) {
            const int low = v & 255;
            bytes[(i * 32 + tx) * 132 + kk] = static_cast<uint8_t>(low);
            v = (v >> 8) + (low >> 7);
        }
    }
    __syncthreads();
    uint32_t* dst = reinterpret_cast<uint32_t*>(out);
    for (int q = ty; q < nl * 32; q += 8) {
        const int i = q >> 5, ml = q & 31;
        const size_t at = (static_cast<size_t>(i) * mp + m0 + ml) * kp + k0;
        dst[at / 4 + tx] = tile[i][ml][tx];
    }
}

}  // namespace

extern "C" {

// out = {BM, BN, BK, kflush}: the multiples the planes are padded to, and
// the k between two folds of the accumulators.
int spasm_modmatmul_tiles(int nl, int* out) {
    switch (nl) {
        case 1: out[1] = Shape<1>::BN; out[3] = Shape<1>::KFLUSH; break;
        case 2: out[1] = Shape<2>::BN; out[3] = Shape<2>::KFLUSH; break;
        case 3: out[1] = Shape<3>::BN; out[3] = Shape<3>::KFLUSH; break;
        case 4: out[1] = Shape<4>::BN; out[3] = Shape<4>::KFLUSH; break;
        case 5: out[1] = Shape<5>::BN; out[3] = Shape<5>::KFLUSH; break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    out[0] = kBM;
    out[2] = kBK;
    return 0;
}

// The limb planes of x (r, c), element strides (sr, sc), into out:
// (nl, rows, cols) as they are, or with transpose != 0 (nl, rows, cols)
// holding x transposed (rows pad c, cols pad r).  run: null, or a device
// flag that skips the launch's work where it reads 0.
int spasm_modmatmul_split(const void* x, long long sr, long long sc, int r,
                          int c, void* out, int rows, int cols, int nl,
                          int transpose, const void* run, void* stream) {
    const uint8_t* go = static_cast<const uint8_t*>(run);
    if (nl < 1 || nl > 5 || r <= 0 || c <= 0 || cols % kBK || rows % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    const int32_t* src = static_cast<const int32_t*>(x);
    int8_t* dst = static_cast<int8_t*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cols / kBK > 65535) return static_cast<int>(cudaErrorInvalidValue);
    if (transpose) {
        if (c > rows || r > cols)
            return static_cast<int>(cudaErrorInvalidValue);
        split_transpose_kernel<<<dim3(rows / 32, cols / kBK), dim3(32, 8), 0,
                                 st>>>(src, sr, sc, r, c, dst, rows, cols,
                                       nl, go);
    } else {
        if (r > rows || c > cols)
            return static_cast<int>(cudaErrorInvalidValue);
        split_rows_kernel<<<dim3(rows / 8, cols / kBK), dim3(32, 8), 0, st>>>(
            src, sr, sc, r, c, dst, rows, cols, nl, go);
    }
    return static_cast<int>(cudaGetLastError());
}

// C = A @ B mod p from the packed planes, or C += A @ B with accumulate;
// skipped where the device flag run reads 0 (see modmatmul_kernel).
int spasm_modmatmul(const void* A, const void* B, void* C, int n, int m,
                    int kp, int np_, int mp, int nl, long long p,
                    const void* weights, int accumulate, const void* run,
                    void* stream) {
    if (nl < 1 || nl > 5) return static_cast<int>(cudaErrorInvalidValue);
    Product a{static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
              static_cast<int32_t*>(C), n, m, kp, np_, mp, p, Weights{},
              accumulate, static_cast<const uint8_t*>(run),
              static_cast<cudaStream_t>(stream)};
    const long long* w = static_cast<const long long*>(weights);
    for (int s = 0; s < 2 * nl - 1; ++s) a.W.w[s] = w[s];
    return static_cast<int>(nl <= 3 ? product_lo(nl, a) : product_hi(nl, a));
}

// The whole of K1 in one call: both splits, then the product.  a (n, k)
// and b (k, m) int32 with element strides; ap (nl, np, kp) and bp (nl, mp,
// kp) int8 scratch; C (n, m) int32, overwritten, or added to with
// accumulate; all three launches skip their work where run reads 0.
int spasm_modmatmul_full(const void* a, long long sa0, long long sa1,
                         const void* b, long long sb0, long long sb1,
                         void* ap, void* bp, void* C, int n, int k, int m,
                         int np_, int kp, int mp, int nl, long long p,
                         const void* weights, int accumulate, const void* run,
                         void* stream) {
    int e = spasm_modmatmul_split(a, sa0, sa1, n, k, ap, np_, kp, nl, 0, run,
                                  stream);
    if (e) return e;
    e = spasm_modmatmul_split(b, sb0, sb1, k, m, bp, mp, kp, nl, 1, run,
                              stream);
    if (e) return e;
    return spasm_modmatmul(ap, bp, C, n, m, kp, np_, mp, nl, p, weights,
                           accumulate, run, stream);
}

const char* spasm_cuda_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
