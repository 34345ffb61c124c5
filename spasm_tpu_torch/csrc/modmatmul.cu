// K1: exact dense matrix product over GF(p) on int8 tensor cores.
//
// Replaces spasm_tpu/ops/pallas_matmul.py::_kernel (launched by _pallas_mm,
// wrapped by modmatmul_pallas).  C = A @ B mod p for balanced int32 A (n, k)
// and B (k, m), given as nl balanced base-256 int8 limb planes each
// (spasm_tpu_torch/ops/modmul.to_limbs, packed and zero-padded by the
// wrapper in ops/cuda_matmul.py):
//
//     A @ B = sum_s D_s * 256**s,   D_s = sum_{i+j=s} A_i @ B_j.
//
// Each CTA keeps one int32 wmma accumulator per limb diagonal D_s for its
// output tile.  |D_s| grows by at most nl * 128 * 128 per k step, so the
// accumulators are flushed into a running balanced total
// (tot = tot + (D_s mod p) * (256**s mod p), reduced exactly in int64)
// before they could pass 2**31; any k is exact, and every legal
// p <= 0xFFFFFFFB is covered (nl = 1..5).
//
// What bounds it on the H100: int8 tensor-core issue (nl*nl mma per
// 16x16x16 fragment step, 4 at the default p = 42013) and, at this tile
// size, the synchronous shared-memory staging that feeds wmma.  The design
// keeps operands at one byte per limb, reads each tile of A and B from
// device memory once per CTA, and does the modular epilogue once per output
// element.  Register pressure grows with the 2nl-1 accumulators, so the
// warp tile shrinks with nl.  A cp.async / TMA pipeline and wgmma are later
// work.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "modp.cuh"

using namespace nvcuda;

namespace {

constexpr int kBK = 32;       // k per shared-memory stage
constexpr int kWarps = 8;     // 2 warps along M x 4 along N
constexpr int kMaxDiag = 9;   // 2 * 5 - 1

struct Weights {
    long long w[kMaxDiag];    // 256**s mod p, balanced
};

// warp tile (WM x WN fragments of 16x16) per limb count: the 2nl-1
// accumulators plus the running total stay near 128 registers a thread
// (ptxas on sm_90a: 2x4 at nl = 1 spilled 64 bytes; 2x2 at nl = 2 spills 8)
template <int NL> struct Tile;
template <> struct Tile<1> { static constexpr int WM = 2, WN = 2; };
template <> struct Tile<2> { static constexpr int WM = 2, WN = 2; };
template <> struct Tile<3> { static constexpr int WM = 1, WN = 2; };
template <> struct Tile<4> { static constexpr int WM = 1, WN = 2; };
template <> struct Tile<5> { static constexpr int WM = 1, WN = 1; };

template <int NL>
struct Shape {
    static constexpr int WM = Tile<NL>::WM, WN = Tile<NL>::WN;
    static constexpr int BM = 2 * WM * 16;
    static constexpr int BN = 4 * WN * 16;
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

template <int ND, int WM, int WN>
__device__ __forceinline__ void flush(AccFrag (&acc)[ND][WM][WN],
                                      AccFrag (&tot)[WM][WN],
                                      const Weights& W, long long p,
                                      double dinv) {
    // the element <-> register mapping is the same for every accumulator
    // fragment of one type, so the combine runs register by register
#pragma unroll
    for (int a = 0; a < WM; ++a)
#pragma unroll
        for (int b = 0; b < WN; ++b)
#pragma unroll
            for (int t = 0; t < tot[a][b].num_elements; ++t) {
                long long s = tot[a][b].x[t];
#pragma unroll
                for (int d = 0; d < ND; ++d) {
                    long long r = bal_reduce(acc[d][a][b].x[t], p, dinv);
                    s = bal_reduce(s + r * W.w[d], p, dinv);
                    acc[d][a][b].x[t] = 0;
                }
                tot[a][b].x[t] = static_cast<int>(s);
            }
}

// A: (NL, np, kp) int8 planes, row-major; B: (NL, kp, mp) int8 planes,
// row-major; C: (n, m) int32.  np, kp, mp are multiples of BM, kBK, BN.
template <int NL>
__global__ void __launch_bounds__(kWarps * 32)
modmatmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                 int32_t* __restrict__ C, int n, int m, int kp, int np_,
                 int mp, long long p, double dinv, Weights W, int kflush) {
    constexpr int ND = 2 * NL - 1;
    constexpr int WM = Shape<NL>::WM, WN = Shape<NL>::WN;
    constexpr int BM = Shape<NL>::BM, BN = Shape<NL>::BN;
    // 16x16 int8 sub-tiles stored contiguously (ldm 16): every wmma load
    // pointer is 256-byte aligned
    __shared__ __align__(128) int8_t As[NL][kBK / 16][BM][16];
    __shared__ __align__(128) int8_t Bs[NL][BN / 16][kBK][16];
    __shared__ __align__(128) int32_t Cs[kWarps][16][16];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wr = warp >> 2, wc = warp & 3;
    // row tiles on x (2**31 - 1 blocks): the tall operands of the dense
    // finish (the accumulated RREF) have far more rows than columns
    const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
    const size_t a_plane = static_cast<size_t>(np_) * kp;
    const size_t b_plane = static_cast<size_t>(kp) * mp;

    AccFrag acc[ND][WM][WN];
    AccFrag tot[WM][WN];
#pragma unroll
    for (int a = 0; a < WM; ++a)
#pragma unroll
        for (int b = 0; b < WN; ++b) {
            wmma::fill_fragment(tot[a][b], 0);
#pragma unroll
            for (int d = 0; d < ND; ++d) wmma::fill_fragment(acc[d][a][b], 0);
        }

    int since_flush = 0;
    for (int k0 = 0; k0 < kp; k0 += kBK) {
        // stage the A and B tiles of every limb plane, 16 bytes a thread
        constexpr int a_chunks = NL * BM * (kBK / 16);
        for (int q = tid; q < a_chunks; q += kWarps * 32) {
            const int plane = q / (BM * (kBK / 16));
            const int rem = q % (BM * (kBK / 16));
            const int r = rem >> 1, h = rem & 1;
            const int4* src = reinterpret_cast<const int4*>(
                A + plane * a_plane + static_cast<size_t>(row0 + r) * kp
                + k0 + h * 16);
            *reinterpret_cast<int4*>(&As[plane][h][r][0]) = __ldg(src);
        }
        constexpr int b_chunks = NL * kBK * (BN / 16);
        for (int q = tid; q < b_chunks; q += kWarps * 32) {
            const int plane = q / (kBK * (BN / 16));
            const int rem = q % (kBK * (BN / 16));
            const int r = rem / (BN / 16), cb = rem % (BN / 16);
            const int4* src = reinterpret_cast<const int4*>(
                B + plane * b_plane + static_cast<size_t>(k0 + r) * mp
                + col0 + cb * 16);
            *reinterpret_cast<int4*>(&Bs[plane][cb][r][0]) = __ldg(src);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                           wmma::row_major> fa[NL][WM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                           wmma::row_major> fb[NL][WN];
#pragma unroll
            for (int i = 0; i < NL; ++i) {
#pragma unroll
                for (int a = 0; a < WM; ++a)
                    wmma::load_matrix_sync(
                        fa[i][a],
                        reinterpret_cast<const signed char*>(
                            &As[i][kk][(wr * WM + a) * 16][0]), 16);
#pragma unroll
                for (int b = 0; b < WN; ++b)
                    wmma::load_matrix_sync(
                        fb[i][b],
                        reinterpret_cast<const signed char*>(
                            &Bs[i][wc * WN + b][kk * 16][0]), 16);
            }
#pragma unroll
            for (int i = 0; i < NL; ++i)
#pragma unroll
                for (int j = 0; j < NL; ++j)
#pragma unroll
                    for (int a = 0; a < WM; ++a)
#pragma unroll
                        for (int b = 0; b < WN; ++b)
                            wmma::mma_sync(acc[i + j][a][b], fa[i][a],
                                           fb[j][b], acc[i + j][a][b]);
        }
        __syncthreads();
        since_flush += kBK;
        if (since_flush >= kflush && k0 + kBK < kp) {
            flush<ND, WM, WN>(acc, tot, W, p, dinv);
            since_flush = 0;
        }
    }
    flush<ND, WM, WN>(acc, tot, W, p, dinv);

    // write back through a per-warp staging tile, masking the ragged edge
#pragma unroll
    for (int a = 0; a < WM; ++a)
#pragma unroll
        for (int b = 0; b < WN; ++b) {
            wmma::store_matrix_sync(&Cs[warp][0][0], tot[a][b], 16,
                                    wmma::mem_row_major);
            __syncwarp();
            const int r0 = row0 + (wr * WM + a) * 16;
            const int c0 = col0 + (wc * WN + b) * 16;
            for (int e = lane; e < 256; e += 32) {
                const int r = r0 + (e >> 4), c = c0 + (e & 15);
                if (r < n && c < m)
                    C[static_cast<size_t>(r) * m + c] = Cs[warp][e >> 4][e & 15];
            }
            __syncwarp();
        }
}

template <int NL>
cudaError_t launch(const int8_t* A, const int8_t* B, int32_t* C, int n,
                   int m, int kp, int np_, int mp, long long p,
                   const Weights& W, cudaStream_t stream) {
    constexpr int BM = Shape<NL>::BM, BN = Shape<NL>::BN;
    if (np_ % BM || mp % BN || kp % kBK || n > np_ || m > mp
        || mp / BN > 65535)
        return cudaErrorInvalidValue;
    // largest k a flush interval may span: nl * 128 * 128 * k < 2**31
    int kflush = static_cast<int>(((1LL << 31) - 1) / (NL * 16384LL));
    kflush -= kflush % kBK;
    dim3 grid(np_ / BM, mp / BN);
    modmatmul_kernel<NL><<<grid, kWarps * 32, 0, stream>>>(
        A, B, C, n, m, kp, np_, mp, p, 1.0 / static_cast<double>(p), W,
        kflush);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the wrapper pads to: out = {BM, BN, BK}.
int spasm_modmatmul_tiles(int nl, int* out) {
    switch (nl) {
        case 1: out[0] = Shape<1>::BM; out[1] = Shape<1>::BN; break;
        case 2: out[0] = Shape<2>::BM; out[1] = Shape<2>::BN; break;
        case 3: out[0] = Shape<3>::BM; out[1] = Shape<3>::BN; break;
        case 4: out[0] = Shape<4>::BM; out[1] = Shape<4>::BN; break;
        case 5: out[0] = Shape<5>::BM; out[1] = Shape<5>::BN; break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    out[2] = kBK;
    return 0;
}

int spasm_modmatmul(const void* A, const void* B, void* C, int n, int m,
                    int kp, int np_, int mp, int nl, long long p,
                    const void* weights, void* stream) {
    Weights W{};
    const long long* w = static_cast<const long long*>(weights);
    for (int s = 0; s < 2 * nl - 1 && s < kMaxDiag; ++s) W.w[s] = w[s];
    const int8_t* a = static_cast<const int8_t*>(A);
    const int8_t* b = static_cast<const int8_t*>(B);
    int32_t* c = static_cast<int32_t*>(C);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    switch (nl) {
        case 1: e = launch<1>(a, b, c, n, m, kp, np_, mp, p, W, st); break;
        case 2: e = launch<2>(a, b, c, n, m, kp, np_, mp, p, W, st); break;
        case 3: e = launch<3>(a, b, c, n, m, kp, np_, mp, p, W, st); break;
        case 4: e = launch<4>(a, b, c, n, m, kp, np_, mp, p, W, st); break;
        case 5: e = launch<5>(a, b, c, n, m, kp, np_, mp, p, W, st); break;
        default: e = cudaErrorInvalidValue;
    }
    return static_cast<int>(e);
}

const char* spasm_cuda_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
