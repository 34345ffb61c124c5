// K2: in-place Jordan elimination of one (n, c) column panel over GF(p).
//
// Replaces the three Pallas panel kernels of spasm_tpu/ops/pallas_panel.py
// (_kernel_scalefree via _panel_scalefree_jit, _kernel via
// panel_eliminate_pallas, _kernel_b via _panel_tier_b_jit).  It reproduces
// spasm_tpu/ops/dense.py::_panel_eliminate bit for bit:
//
//   for jj in 0..c-1 (only while j0 + jj < npivcols):
//     pr    = first row i with !is_piv[i] and P[i, jj] != 0 (else skip jj)
//     pinv  = P[pr, jj]**-1
//     beta_i = -P[i, jj] * pinv (i != pr),  beta_pr = pinv - 1
//     g_row = G[pr] + e_kk
//     P += beta (x) P[pr];  G += beta (x) g_row
//     prow[kk] = pr, pcol[kk] = jj, pfound[kk] = 1, is_piv[pr] = 1, kk++
//
// One per-step form with int64 products covers every legal p and every n:
// balanced products stay below (p/2)**2 < 2**62 for p <= 0xFFFFFFFB, so the
// TPU's scale-free and uint32 variants fold into this one kernel.  P must
// hold balanced values (every caller's does).
//
// What bounds it on the H100: the steps are sequential, and each one is a
// rank-1 update of the panel (P and G, about 1 MB at n = 1000, c = 128),
// which stays L2-resident, done by one CTA: the update is bound by how many
// L2 loads one SM keeps in flight, and the per-step latency (a column scan,
// a block-wide min, one Fermat inverse on one thread, three barriers) adds
// to it.  The design writes beta once per step into a scratch vector, then
// walks the (rows x columns) rectangle flat, 16 bytes per access where c is
// a multiple of 4, with kUnroll loads in flight per thread before its first
// store; it skips rows whose beta is 0 and touches only the columns that
// can change: P from jj on (the pivot row is 0 left of jj) and G up to slot
// kk (g_row is 0 beyond it).  A multi-CTA or cluster design is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "modp.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;   // loads each thread issues before it stores

__device__ long long inv_mod(long long v, long long p, double dinv) {
    // Fermat: v**(p-2), balanced; v != 0
    long long e = p - 2, r = 1, b = v;
    while (e) {
        if (e & 1) r = bal_reduce(r * b, p, dinv);
        b = bal_reduce(b * b, p, dinv);
        e >>= 1;
    }
    return r;
}

template <int V> struct VecOf;
template <> struct VecOf<1> { using type = int32_t; };
template <> struct VecOf<4> { using type = int4; };

// M[i, V*q0 : V*(q0 + wq)] += beta[i] * src[same columns] (balanced mod p)
// for every row i < n with beta[i] != 0.  The (n, wq) rectangle of V-wide
// vectors is walked flat, blockDim vectors apart; (i, t) advance by
// (dq, dr) with a carry instead of a division per element.
template <int V>
__device__ __forceinline__ void rank1_update(
        int32_t* __restrict__ M, int n, int c, int q0, int wq,
        const int32_t* __restrict__ beta, const int32_t* __restrict__ src,
        long long p, double dinv) {
    using Vec = typename VecOf<V>::type;
    if (wq <= 0) return;
    Vec* Mv = reinterpret_cast<Vec*>(M) + q0;
    const Vec* Sv = reinterpret_cast<const Vec*>(src) + q0;
    const size_t cq = static_cast<size_t>(c / V);
    const int dq = blockDim.x / wq, dr = blockDim.x % wq;
    int i = threadIdx.x / wq, t = threadIdx.x % wq;
    while (i < n) {
        int ii[kUnroll], tt[kUnroll];
        int32_t b[kUnroll];
        Vec v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            ii[u] = i;
            tt[u] = t;
            b[u] = i < n ? beta[i] : 0;
            v[u] = b[u] ? Mv[ii[u] * cq + t] : Vec{};
            t += dr;
            i += dq;
            if (t >= wq) {
                t -= wq;
                ++i;
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (!b[u]) continue;
            const Vec s = Sv[tt[u]];
            int32_t* pv = reinterpret_cast<int32_t*>(&v[u]);
            const int32_t* ps = reinterpret_cast<const int32_t*>(&s);
#pragma unroll
            for (int k = 0; k < V; ++k)
                pv[k] = static_cast<int32_t>(bal_reduce(
                    pv[k] + static_cast<long long>(b[u]) * ps[k], p, dinv));
            Mv[ii[u] * cq + tt[u]] = v[u];
        }
    }
}

__global__ void __launch_bounds__(kThreads)
panel_kernel(int32_t* __restrict__ P, int32_t* __restrict__ G,
             uint8_t* __restrict__ ispiv, int32_t* __restrict__ beta,
             int32_t* __restrict__ prow, int32_t* __restrict__ pcol,
             uint8_t* __restrict__ pfound, int n, int c, int j0,
             int npivcols, long long p, double dinv, int vec4) {
    // pivot row [c], g_row [c]; 16-byte aligned for the int4 path
    extern __shared__ __align__(16) int32_t stage[];
    int32_t* srow = stage;
    int32_t* grow = stage + c;
    __shared__ int red[kThreads / 32];
    __shared__ int s_pr;
    __shared__ long long s_pinv;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    int kk = 0;
    for (int jj = 0; jj < c && j0 + jj < npivcols; ++jj) {
        // first candidate row: each thread's first hit in its strided
        // rows is its minimum; then a block-wide min
        int best = n;
        for (int i = tid; i < n; i += blockDim.x)
            if (!ispiv[i] && P[static_cast<size_t>(i) * c + jj] != 0) {
                best = i;
                break;
            }
        best = __reduce_min_sync(0xffffffffu, best);
        if (lane == 0) red[warp] = best;
        __syncthreads();
        if (warp == 0) {
            int v = lane < nwarps ? red[lane] : n;
            v = __reduce_min_sync(0xffffffffu, v);
            if (lane == 0) {
                s_pr = v;
                if (v < n)
                    s_pinv = inv_mod(P[static_cast<size_t>(v) * c + jj], p,
                                     dinv);
            }
        }
        __syncthreads();
        const int pr = s_pr;
        if (pr >= n) continue;           // no candidate: a no-op step
        const long long pinv = s_pinv;
        for (int t = tid; t < c; t += blockDim.x) {
            srow[t] = P[static_cast<size_t>(pr) * c + t];
            // G[pr, kk] is 0 before this step (slot kk unused)
            grow[t] = G[static_cast<size_t>(pr) * c + t] + (t == kk ? 1 : 0);
        }
        const int bpr = static_cast<int>(bal_reduce(pinv - 1, p, dinv));
        for (int i = tid; i < n; i += blockDim.x) {
            const int col = P[static_cast<size_t>(i) * c + jj];
            beta[i] = i == pr ? bpr
                : col == 0 ? 0
                : static_cast<int>(bal_reduce(
                      -static_cast<long long>(col) * pinv, p, dinv));
        }
        __syncthreads();    // row pr and beta are read before any write
        if (vec4) {
            const int q0 = jj >> 2;
            rank1_update<4>(P, n, c, q0, (c >> 2) - q0, beta, srow, p, dinv);
            rank1_update<4>(G, n, c, 0, (kk >> 2) + 1, beta, grow, p, dinv);
        } else {
            rank1_update<1>(P, n, c, jj, c - jj, beta, srow, p, dinv);
            rank1_update<1>(G, n, c, 0, kk + 1, beta, grow, p, dinv);
        }
        if (tid == 0) {
            ispiv[pr] = 1;
            prow[kk] = pr;
            pcol[kk] = jj;
            pfound[kk] = 1;
        }
        ++kk;
        __syncthreads();    // updates visible to the next scan
    }
}

}  // namespace

// beta: int32 scratch of n entries.  P and G: contiguous (n, c) int32.
extern "C" int spasm_panel_eliminate(void* P, void* G, void* ispiv,
                                     void* beta, void* prow, void* pcol,
                                     void* pfound, int n, int c, int j0,
                                     int npivcols, long long p,
                                     void* stream) {
    if (n < 0 || c <= 0 || c > 4096)
        return static_cast<int>(cudaErrorInvalidValue);
    const int vec4 = (c % 4 == 0)
        && reinterpret_cast<uintptr_t>(P) % 16 == 0
        && reinterpret_cast<uintptr_t>(G) % 16 == 0;
    const size_t smem = 2 * static_cast<size_t>(c) * sizeof(int32_t);
    panel_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(P), static_cast<int32_t*>(G),
        static_cast<uint8_t*>(ispiv), static_cast<int32_t*>(beta),
        static_cast<int32_t*>(prow), static_cast<int32_t*>(pcol),
        static_cast<uint8_t*>(pfound), n, c, j0, npivcols, p,
        1.0 / static_cast<double>(p), vec4);
    return static_cast<int>(cudaGetLastError());
}
