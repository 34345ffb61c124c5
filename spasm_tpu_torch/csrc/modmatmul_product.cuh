// K1's product kernel: see modmatmul.cu for what it computes and why it is
// shaped this way.  A header, because its five instantiations (one per limb
// count) are compiled by two sources side by side.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums: types only, the
                            // encoder is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "modp.cuh"
#include "wgmma_s8.cuh"

namespace spasm_k1 {


constexpr int kBM = 128;         // rows of C per CTA: two warpgroups x 64
constexpr int kBK = 128;         // k per stage: one swizzled 128-byte row
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kMaxDiag = 9;      // 2 * 5 - 1
constexpr int kSmemMax = 227 * 1024;
// registers a thread after setmaxnreg: the producer is one thread with a
// short loop.  128 * 24 + 256 * 240 = 64512 <= 65536.
constexpr int kRegsProducer = 24, kRegsConsumer = 240;

struct Weights {
    long long w[kMaxDiag];       // 256**s mod p, balanced
};

template <int NL> struct Width;  // BN: columns of C per CTA
template <> struct Width<1> { static constexpr int BN = 128; };
template <> struct Width<2> { static constexpr int BN = 128; };
template <> struct Width<3> { static constexpr int BN = 64; };
template <> struct Width<4> { static constexpr int BN = 32; };
template <> struct Width<5> { static constexpr int BN = 32; };

template <int NL>
struct Shape {
    static constexpr int BN = Width<NL>::BN;
    static constexpr int ND = 2 * NL - 1;
    static constexpr int A_PLANE = kBM * kBK;        // bytes per plane tile
    static constexpr int B_PLANE = BN * kBK;
    static constexpr int A_BYTES = NL * A_PLANE;
    static constexpr int STAGE = A_BYTES + NL * B_PLANE;
    // 1024 bytes to align the ring, 128 for the mbarriers
    static constexpr int FIT = (kSmemMax - 1024 - 128) / STAGE;
    static constexpr int STAGES = FIT > 6 ? 6 : FIT;
    static constexpr int SMEM = STAGES * STAGE + 1024 + 128;
    // largest k one fold interval may span: nl * 128 * 128 * k < 2**31
    static constexpr int KFLUSH =
        static_cast<int>(((1LL << 31) - 1) / (NL * 16384LL)) / kBK * kBK;
    static_assert(STAGES >= 2, "the ring needs two stages");
    static_assert(A_PLANE % 1024 == 0 && B_PLANE % 1024 == 0,
                  "swizzled tiles start on 1024-byte boundaries");
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
          "r"(c1) : "memory");
}

// ------------------------------------------------------- the product

// Fold the diagonals mod p into C: C = (prev ? C : 0) + sum_s (D_s mod p)
// * w_s, balanced.  Every thread touches only its own elements of C (the
// wgmma accumulator layout of wgmma_s8.cuh), so a fold in the middle of
// the k loop needs no synchronization with any other; the next k stage
// then starts the diagonals anew (the wgmma's scale-d).
template <int ND, int BN>
__device__ __forceinline__ void fold(const int (&acc)[ND][BN / 2], int32_t* C,
                                     int n, int m, int row, int col,
                                     bool prev, const Weights& W,
                                     long long p, double dinv) {
    const bool pairs = (m & 1) == 0;   // then (r, even c) is 8-byte aligned
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h, c = col + 8 * j;
            if (r >= n || c >= m) continue;
            int32_t* at = C + static_cast<size_t>(r) * m + c;
            int v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int t = 4 * j + 2 * h + e;
                long long s = (prev && c + e < m) ? at[e] : 0;
                if constexpr (ND <= 3) {
                    // up to 2 limbs p < 2**16: the whole weighted sum stays
                    // below 3 * 2**31 * 2**15 + 2**15 < 2**48, one
                    // reduction (the weights fit int32: one 32 x 32 -> 64
                    // multiply-add each)
#pragma unroll
                    for (int d = 0; d < ND; ++d)
                        s += static_cast<long long>(acc[d][t])
                            * static_cast<int>(W.w[d]);
                    v[e] = bal_reduce_fma(s, static_cast<int>(p), dinv);
                } else {
#pragma unroll
                    for (int d = 0; d < ND; ++d) {
                        const long long q = bal_reduce(acc[d][t], p, dinv);
                        s = bal_reduce(s + q * W.w[d], p, dinv);
                    }
                    v[e] = static_cast<int>(s);
                }
            }
            if (pairs) {
                *reinterpret_cast<int2*>(at) = make_int2(v[0], v[1]);
            } else {
                at[0] = v[0];
                if (c + 1 < m) at[1] = v[1];
            }
        }
}

// tmA / tmB: tensor maps of the packed planes, Ap (NL, np, kp) int8 of A
// and Bp (NL, mp, kp) int8 of B transposed (both row-major with np, mp, kp
// multiples of kBM, BN, kBK), as 2-D (NL * rows, kp) byte tensors with a
// 128-byte-swizzled box of (rows of the tile, 128).  C: (n, m) int32.
// fold_stages: k stages between two folds.  accumulate != 0: C holds a
// balanced addend on entry and the result is C + A @ B (the first fold
// reads C).  run: null, or a device flag; where it reads 0 every CTA
// returns at once and C is left as it is (a product the caller's device
// predicate skips, as the reference's lax.cond does, with no host read).
template <int NL>
__global__ void __launch_bounds__(kThreads, 1)
modmatmul_kernel(const __grid_constant__ CUtensorMap tmA,
                 const __grid_constant__ CUtensorMap tmB, int32_t* C, int n,
                 int m, int kp, int np_, int mp, long long p, double dinv,
                 Weights W, int fold_stages, int accumulate,
                 const uint8_t* __restrict__ run) {
    if (run != nullptr && *run == 0) return;
    using S = Shape<NL>;
    constexpr int BN = S::BN, ND = S::ND, STAGES = S::STAGES;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t bars = ring + STAGES * S::STAGE;
    // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int nk = kp / kBK;
    // row tiles on x (2**31 - 1 blocks): the tall operands of the dense
    // finish (the accumulated RREF) have far more rows than columns
    const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * BN;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bars + 8 * s, 1);
            mbar_init(bars + 8 * (STAGES + s), kConsumers * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == kConsumers) {
        // ---- producer warpgroup: one thread starts the TMA loads
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     ::"n"(kRegsProducer));
        if (tid == kConsumers * 128) {
            for (int it = 0; it < nk; ++it) {
                const int s = it % STAGES;
                const uint32_t par = (it / STAGES) & 1;
                mbar_wait(bars + 8 * (STAGES + s), par ^ 1);
                const uint32_t full = bars + 8 * s;
                mbar_expect_tx(full, S::STAGE);
                const uint32_t st = ring + s * S::STAGE;
#pragma unroll
                for (int i = 0; i < NL; ++i) {
                    tma_load_2d(st + i * S::A_PLANE, &tmA, full, it * kBK,
                                i * np_ + row0);
                    tma_load_2d(st + S::A_BYTES + i * S::B_PLANE, &tmB, full,
                                it * kBK, i * mp + col0);
                }
            }
        }
    } else {
        // ---- consumer warpgroups: 64 rows each
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     ::"n"(kRegsConsumer));
        // cleared by the first wgmma of each diagonal (keep = 0): nothing
        // but wgmma ever writes an accumulator
        int acc[ND][BN / 2];
        const int lane = tid & 31, warp = (tid >> 5) & 3;
        const int row = row0 + wg * 64 + warp * 16 + (lane >> 2);
        const int col = col0 + 2 * (lane & 3);
        const uint64_t descA = wgmma_desc_k128(ring + wg * 64 * kBK);
        const uint64_t descB = wgmma_desc_k128(ring + S::A_BYTES);
        bool folded = accumulate != 0;
        int since = 0, keep = 0;   // 0 at the start and after a fold
        for (int it = 0; it < nk; ++it) {
            const int s = it % STAGES;
            mbar_wait(bars + 8 * s, (it / STAGES) & 1);
            const uint64_t off = static_cast<uint64_t>(s * S::STAGE) >> 4;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 32; ++kk)
#pragma unroll
                for (int i = 0; i < NL; ++i)
#pragma unroll
                    for (int j = 0; j < NL; ++j)
                        // (i, j) is the first product of its diagonal in
                        // this order when i == 0 or j == NL - 1
                        MmaS8<BN>::mma(
                            acc[i + j],
                            descA + off + ((i * S::A_PLANE) >> 4) + 2 * kk,
                            descB + off + ((j * S::B_PLANE) >> 4) + 2 * kk,
                            (kk == 0 && (i == 0 || j == NL - 1)) ? keep : 1);
            wgmma_commit();
            keep = 1;
            // the group before this one has finished: its stage is free
            wgmma_wait<1>();
            if (it > 0) {
                __syncwarp();
                if (lane == 0)
                    mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
            }
            if (++since == fold_stages && it + 1 < nk) {
                wgmma_wait<0>();
                fold<ND, BN>(acc, C, n, m, row, col, folded, W, p, dinv);
                folded = true;
                since = keep = 0;
            }
        }
        wgmma_wait<0>();
        fold<ND, BN>(acc, C, n, m, row, col, folded, W, p, dinv);
    }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime: nothing links against libcuda
inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn) return fn;
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(sym);
    return fn;
}

// (rows, kp) bytes, row-major, in boxes of (box_rows, 128), 128-byte swizzle
inline cudaError_t plane_map(CUtensorMap* map, const int8_t* base,
                             long long rows, int kp, int box_rows) {
    EncodeTiled enc = encoder();
    if (!enc) return cudaErrorNotSupported;
    cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                          static_cast<cuuint64_t>(rows)};
    cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
    cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
    cuuint32_t elem[2] = {1, 1};
    CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                     const_cast<int8_t*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// what a product launch takes (see modmatmul_kernel)
struct Product {
    const int8_t* A;
    const int8_t* B;
    int32_t* C;
    int n, m, kp, np_, mp;
    long long p;
    Weights W;
    int accumulate;          // C += A @ B (C holds the addend)
    const uint8_t* run;      // null, or a device flag: 0 skips the product
    cudaStream_t stream;
};

template <int NL>
cudaError_t launch(const Product& a) {
    using S = Shape<NL>;
    if (a.np_ % kBM || a.mp % S::BN || a.kp % kBK || a.kp <= 0
        || a.n > a.np_ || a.m > a.mp || a.n <= 0 || a.m <= 0
        || a.mp / S::BN > 65535)
        return cudaErrorInvalidValue;
    auto kern = modmatmul_kernel<NL>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return e;
    CUtensorMap ta, tb;
    e = plane_map(&ta, a.A, static_cast<long long>(NL) * a.np_, a.kp, kBM);
    if (e != cudaSuccess) return e;
    e = plane_map(&tb, a.B, static_cast<long long>(NL) * a.mp, a.kp, S::BN);
    if (e != cudaSuccess) return e;
    dim3 grid(a.np_ / kBM, a.mp / S::BN);
    kern<<<grid, kThreads, S::SMEM, a.stream>>>(
        ta, tb, a.C, a.n, a.m, a.kp, a.np_, a.mp, a.p,
        1.0 / static_cast<double>(a.p), a.W, S::KFLUSH / kBK, a.accumulate,
        a.run);
    return cudaGetLastError();
}

// The instantiations are spread over two sources so that they compile
// side by side: 1-3 limbs (modmatmul_lo.cu) and 4-5 (modmatmul_hi.cu).
cudaError_t product_lo(int nl, const Product& a);
cudaError_t product_hi(int nl, const Product& a);

}  // namespace spasm_k1
