// K2: in-place Jordan elimination of one (n, c) column panel over GF(p),
// on one thread-block cluster.
//
// Replaces the three Pallas panel kernels of spasm_tpu/ops/pallas_panel.py
// (_kernel_scalefree via _panel_scalefree_jit, _kernel via
// panel_eliminate_pallas, _kernel_b via _panel_tier_b_jit).  It reproduces
// spasm_tpu_torch/ops/dense.py::_panel_eliminate bit for bit:
//
//   for jj in 0..c-1 (only while j0 + jj < npivcols):
//     pr    = first row i with !is_piv[i] and P[i, jj] != 0 (else skip jj)
//     pinv  = P[pr, jj]**-1
//     beta_i = -P[i, jj] * pinv (i != pr),  beta_pr = pinv - 1
//     P += beta (x) P[pr];  G += beta (x) (G[pr] + e_kk)
//     prow[kk] = pr, pcol[kk] = jj, pfound[kk] = 1, is_piv[pr] = 1, kk++
//
// It runs the TPU's scale-free recurrence (_kernel_scalefree) instead: with
// pv = P[pr, jj] and col_i = P[i, jj] as stored, each step is
//
//   P_i <- pv * P_i - col_i * P[pr]              (i != pr, col_i != 0)
//   H_i <- pv * H_i - col_i * (H[pr] + s[pr] e_kk)
//   s_i <- pv * s_i;  H[pr, kk] = s[pr] - pv;  s[pr] <- pv
//
// which keeps P_i = s_i * T_i and H_i = s_i * G_i for the outputs (T, G) of
// the form above.  A row with col_i == 0 is left alone (its T and G do not
// change, so any scale stays valid).  One Fermat inverse per row at the
// end gives (T, G); a residue is unique mod p, so the bits are the same.
// The products are int64: for p <= 0xFFFFFFFB, |pv * x - col * y| <=
// 2 ((p - 1) / 2)**2 < 2**63 - 2**34, and bal_reduce needs |x| / p < 2**50.
// For p <= 65535 the same sum is below 2**31 and runs in int32 with a float
// quotient (the TPU's _mod_balanced_f32).
//
// What bounds it on the H100: the c steps are sequential, and each one is a
// rank-1 update of the panel.  At the main path's n = 1000, c = 128 that is
// about 15 M mod-p multiply-adds (two products and one reduction each) and
// 1.5 MB of P, G and flags to read and write once: under a microsecond of
// the card's bytes or ALU rate (chip_smoke.py prints the bound), so what
// bounds it is the chain of 128 dependent steps.  The single-CTA design
// this replaces streamed the whole 1 MB through one SM every step and took
// a Fermat inverse on one thread per step: 3.1 ms at that shape on an H100
// SXM at 700 W.  This design:
//
// * spreads the rows over a cluster of kCluster = 16 CTAs (the H100's
//   non-portable maximum; where no such cluster can be resident the launch
//   fails and the wrapper raises), each owning a contiguous tile and
//   keeping its rows of P and
//   H, their scales and the is_piv flags in its own shared memory (at n =
//   1000, c = 128: 63 rows, 66 KB); where a tile does not fit it works on
//   the rows in global memory (L2) with the same split;
// * runs each step on ONE cluster barrier: each CTA scans its rows of
//   column jj and pushes its first candidate, with that row's pv and s,
//   into every CTA's inbox (remote stores need no round trip; an inbox
//   slot is double-buffered by step parity); after barrier.cluster every
//   warp takes the min of its local inbox; warp 0 stages the pivot row
//   (P[pr] and H[pr], the latter up to slot kk) from its owner through
//   distributed shared memory while the other warps update the scales;
//   then each CTA updates only its own rows.  The owner may write H[pr, kk]
//   and s[pr] in the same step: readers never load them (they take s[pr]
//   from the inbox and put it in slot kk themselves), and P[pr] does not
//   change in its own step.  The next step's barrier orders all of this
//   before row pr is written again;
// * has no inverse on the step chain: one per row, in the epilogue.
//
// With a stamps buffer, thread 0 of CTA 0 writes the global timer at the
// ends of a step's phases (kPhases per column): chip_smoke.py's k2 phase
// prints where a step's time goes.
//
// An optional one-byte device flag (run) is the reference's empty-panel
// lax.cond (spasm_tpu/ops/dense.py:187-195) and its early exit: where it
// reads 0 the kernel returns before its first cluster barrier, so the
// dense finish decides on the card, inside one CUDA graph, which panels
// run.  Under a stream capture the launch skips its residency query (the
// eager run of the same shapes before the capture has made it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "modp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 16;
constexpr int kRows = 4;      // rows each update thread loads before it stores
// step phases stamped: start, candidate pushed, cluster barrier passed,
// pivot row staged, own rows updated, step done
constexpr int kPhases = 6;

__device__ __forceinline__ long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return static_cast<long long>(t);
}

// opt-in dynamic shared memory of one block (232,448 bytes) less a margin
// for the static arrays
constexpr size_t kSmemCap = 232448 - 1024;

// every p <= 0xFFFFFFFB: int64 products, double quotient
struct ModWide {
    long long p;
    double dinv;
    __device__ __forceinline__ int lin(int a, int x, int b, int y) const {
        return static_cast<int>(bal_reduce(
            static_cast<long long>(a) * x - static_cast<long long>(b) * y,
            p, dinv));
    }
    __device__ __forceinline__ int mul(int a, int x) const {
        return static_cast<int>(bal_reduce(static_cast<long long>(a) * x, p,
                                           dinv));
    }
};

// p <= 65535: |a x - b y| <= 2 * 32767**2 < 2**31 in int32; the float
// quotient of x < 2**31 is within 0.51 of x / p, so one fold suffices.  It
// is rounded to an integer by adding 1.5 * 2**23 in the same fused
// multiply-add (|x / p| < 2**22), whose bits then hold it: one conversion
// per reduction, not two, on the SM's slowest pipe.
struct ModSmall {
    int p;
    float finv;
    __device__ __forceinline__ int red(int x) const {
        const float qf = fmaf(__int2float_rn(x), finv, 12582912.0f);
        const int q = __float_as_int(qf) - 0x4B400000;
        int r = x - q * p;
        const int half = p >> 1;
        if (r > half) r -= p;
        else if (r < -half) r += p;
        return r;
    }
    __device__ __forceinline__ int lin(int a, int x, int b, int y) const {
        return red(a * x - b * y);
    }
    __device__ __forceinline__ int mul(int a, int x) const {
        return red(a * x);
    }
};

template <class Mod>
__device__ int inv_mod(const Mod& mod, int v, long long p) {
    // Fermat: v**(p-2), balanced; v != 0
    long long e = p - 2;
    int r = 1, b = v;
    while (e) {
        if (e & 1) r = mod.mul(r, b);
        b = mod.mul(b, b);
        e >>= 1;
    }
    return r;
}

// row stride of the rows kept in shared memory: a multiple of 4 (16-byte
// rows) with an odd number of 16-byte units, so the 32 rows of a warp's
// column scan fall on 8 banks rather than 1
__host__ __device__ constexpr int smem_row_stride(int c4) {
    return c4 + (((c4 >> 2) & 1) ? 8 : 4);
}

template <int V> struct VecOf;
template <> struct VecOf<1> { using type = int32_t; };
template <> struct VecOf<4> { using type = int4; };

template <int V>
__device__ __forceinline__ int32_t* lanes(typename VecOf<V>::type& v) {
    return reinterpret_cast<int32_t*>(&v);
}

// one CTA's candidate of a step: the row (n if none), and that row's pivot
// value and scale
struct __align__(16) Slot {
    int row, pv, s, pad;
};

template <class Mod, int V>
__global__ void __launch_bounds__(kThreads, 1)
panel_cluster_kernel(int32_t* __restrict__ P, int32_t* __restrict__ G,
                     uint8_t* __restrict__ ispiv, int32_t* __restrict__ scr,
                     int32_t* __restrict__ prow, int32_t* __restrict__ pcol,
                     uint8_t* __restrict__ pfound, int n, int c, int j0,
                     int npivcols, long long p, Mod mod, int rpc,
                     int in_smem, long long* __restrict__ stamps,
                     const uint8_t* __restrict__ run) {
    // the reference's empty-panel lax.cond, on the device: where the flag
    // reads 0 every CTA leaves before its first cluster barrier, and the
    // outputs are the caller's zeroed G / prow / pcol / pfound and the
    // untouched is_piv
    if (run != nullptr && *run == 0) return;
    using Vec = typename VecOf<V>::type;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthr = blockDim.x, nwarps = nthr >> 5;
    const int row0 = min(n, rank * rpc);
    const int nloc = min(n, row0 + rpc) - row0;
    const int cq = c / V;
    const int c4 = (c + 3) & ~3;
    long long* const stamp = rank == 0 && tid == 0 ? stamps : nullptr;

    // the candidates of the CTAs of the cluster, by step parity and rank
    __shared__ Slot inbox[2][kCluster];
    __shared__ int red[kThreads / 32];
    extern __shared__ __align__(16) int32_t dyn[];
    // the staged pivot row and h row (16-byte aligned: c4 is a multiple
    // of 4), then, in shared-memory mode, this CTA's rows
    int32_t* srow = dyn;
    int32_t* hrow = dyn + c4;
    int32_t *Pl, *Hl, *sl, *cl;
    uint8_t* il;
    int ld;
    if (in_smem) {
        ld = smem_row_stride(c4);
        Pl = hrow + c4;
        Hl = Pl + static_cast<size_t>(rpc) * ld;
        sl = Hl + static_cast<size_t>(rpc) * ld;
        cl = sl + ((rpc + 3) & ~3);
        il = reinterpret_cast<uint8_t*>(cl + ((rpc + 3) & ~3));
        for (int r = warp; r < nloc; r += nwarps) {
            const int32_t* src = P + static_cast<size_t>(row0 + r) * c;
            for (int t = lane; t < c4; t += 32) {
                Pl[r * ld + t] = t < c ? src[t] : 0;
                Hl[r * ld + t] = 0;
            }
        }
        for (int r = tid; r < nloc; r += nthr) il[r] = ispiv[row0 + r];
    } else {
        ld = c;
        Pl = P + static_cast<size_t>(row0) * c;
        Hl = G + static_cast<size_t>(row0) * c;   // zeroed by the caller
        sl = scr + row0;
        cl = scr + n + row0;
        il = ispiv + row0;
    }
    for (int r = tid; r < nloc; r += nthr) sl[r] = 1;
    __syncthreads();

    // the update's thread layout: vector column q, row group g of G
    const int groups = max(1, nthr / cq);
    const int g = tid / cq;
    const int qstep = groups > 1 ? cq : nthr;

    int kk = 0, step = 0;
    for (int jj = 0; jj < c && j0 + jj < npivcols; ++jj, ++step) {
        const int par = step & 1;
        if (stamp) stamp[jj * kPhases + 0] = global_ns();
        // 1. this CTA's first candidate in column jj; keep the column
        int best = n;
        for (int r = tid; r < nloc; r += nthr) {
            const int v = Pl[static_cast<size_t>(r) * ld + jj];
            cl[r] = v;
            if (v != 0 && !il[r]) best = min(best, row0 + r);
        }
        best = __reduce_min_sync(0xffffffffu, best);
        if (lane == 0) red[warp] = best;
        __syncthreads();
        if (warp == 0) {
            int v = lane < nwarps ? red[lane] : n;
            v = __reduce_min_sync(0xffffffffu, v);
            Slot sv{v, 0, 0, 0};
            if (v < n) {
                sv.pv = cl[v - row0];
                sv.s = sl[v - row0];
            }
            // push it into every CTA's inbox: stores need no round trip
            if (lane < kCluster)
                *cluster.map_shared_rank(&inbox[par][rank], lane) = sv;
        }
        if (stamp) stamp[jj * kPhases + 1] = global_ns();
        cluster.sync();
        if (stamp) stamp[jj * kPhases + 2] = global_ns();
        // 2. every warp takes the min over the kCluster candidates in its
        // inbox
        const Slot mine =
            lane < kCluster ? inbox[par][lane] : Slot{n, 0, 0, 0};
        const int pr = __reduce_min_sync(0xffffffffu, mine.row);
        if (pr >= n) continue;           // no candidate: a no-op step
        const int src = __ffs(__ballot_sync(
            0xffffffffu, lane < kCluster && mine.row == pr)) - 1;
        const int pv = __shfl_sync(0xffffffffu, mine.pv, src);
        const int s_pr = __shfl_sync(0xffffffffu, mine.s, src);
        const int owner = pr / rpc;
        const int lpr = owner == rank ? pr - row0 : -1;
        const int jq = jj / V, kq = kk / V;
        if (warp == 0) {
            // 3. stage P[pr] and H[pr] + s[pr] e_kk from the owner: H up
            // to slot kk, whose own value the owner may be writing
            // meanwhile; every remote load of a lane before its first store
            const size_t roff = static_cast<size_t>(pr - owner * rpc) * ld;
            const int32_t* rp;
            const int32_t* rh;
            if (in_smem) {
                rp = cluster.map_shared_rank(Pl, owner) + roff;
                rh = cluster.map_shared_rank(Hl, owner) + roff;
            } else {
                rp = P + static_cast<size_t>(pr) * c;
                rh = G + static_cast<size_t>(pr) * c;
            }
            const Vec* rpv = reinterpret_cast<const Vec*>(rp);
            const Vec* rhv = reinterpret_cast<const Vec*>(rh);
            for (int q = lane; q < cq; q += 32) {
                const Vec a = in_smem ? rpv[q] : __ldcg(rpv + q);
                Vec h{};
                if (q < kq) {
                    h = in_smem ? rhv[q] : __ldcg(rhv + q);
                } else if (q == kq) {
                    int32_t* e = lanes<V>(h);
#pragma unroll
                    for (int k = 0; k < V; ++k) {
                        const int t = q * V + k;
                        e[k] = t < kk ? (in_smem ? rh[t] : __ldcg(rh + t))
                             : t == kk ? s_pr : 0;
                    }
                }
                reinterpret_cast<Vec*>(srow)[q] = a;
                if (q <= kq) reinterpret_cast<Vec*>(hrow)[q] = h;
            }
        } else {
            // meanwhile the other warps: the scales, and the pivot row's
            // scale, slot kk of H and flag; bookkeeping
            for (int r = tid - 32; r < nloc; r += nthr - 32)
                if (r == lpr) sl[r] = pv;
                else if (cl[r] != 0) sl[r] = mod.mul(pv, sl[r]);
            if (tid == 32) {
                if (lpr >= 0) {
                    Hl[static_cast<size_t>(lpr) * ld + kk] =
                        mod.lin(1, s_pr, 1, pv);
                    il[lpr] = 1;
                }
                if (rank == 0) {
                    prow[kk] = pr;
                    pcol[kk] = jj;
                    pfound[kk] = 1;
                }
            }
        }
        __syncthreads();                 // the staged rows are complete
        if (stamp) stamp[jj * kPhases + 3] = global_ns();
        // 4. this CTA's rows: P from column jj on (a row that is not yet
        // a pivot row is 0 left of jj, and so is P[pr]) or whole for pivot
        // rows; H up to slot kk (both are 0 beyond it).  kRows rows at a
        // time, all loads before the first store.
        if (g < groups) {
            for (int q = tid % cq; q < cq; q += qstep) {
                Vec sp = reinterpret_cast<const Vec*>(srow)[q];
                Vec hp = q <= kq ? reinterpret_cast<const Vec*>(hrow)[q]
                                 : Vec{};
                const int32_t* se = lanes<V>(sp);
                const int32_t* he = lanes<V>(hp);
                for (int i0 = g; i0 < nloc; i0 += kRows * groups) {
                    int b[kRows];
                    bool dp[kRows], dh[kRows];
                    Vec xp[kRows], xh[kRows];
#pragma unroll
                    for (int u = 0; u < kRows; ++u) {
                        const int i = i0 + u * groups;
                        b[u] = i < nloc && i != lpr ? cl[i] : 0;
                        dp[u] = b[u] != 0 && (q >= jq || il[i]);
                        dh[u] = b[u] != 0 && q <= kq;
                        const size_t off = static_cast<size_t>(i) * ld;
                        if (dp[u]) xp[u] = reinterpret_cast<Vec*>(Pl + off)[q];
                        if (dh[u]) xh[u] = reinterpret_cast<Vec*>(Hl + off)[q];
                    }
#pragma unroll
                    for (int u = 0; u < kRows; ++u) {
                        const size_t off =
                            static_cast<size_t>(i0 + u * groups) * ld;
                        if (dp[u]) {
                            int32_t* xe = lanes<V>(xp[u]);
#pragma unroll
                            for (int k = 0; k < V; ++k)
                                xe[k] = mod.lin(pv, xe[k], b[u], se[k]);
                            reinterpret_cast<Vec*>(Pl + off)[q] = xp[u];
                        }
                        if (dh[u]) {
                            int32_t* xe = lanes<V>(xh[u]);
#pragma unroll
                            for (int k = 0; k < V; ++k)
                                xe[k] = mod.lin(pv, xe[k], b[u], he[k]);
                            reinterpret_cast<Vec*>(Hl + off)[q] = xh[u];
                        }
                    }
                }
            }
        }
        if (stamp) stamp[jj * kPhases + 4] = global_ns();
        ++kk;
        __syncthreads();                 // updates visible to the next scan
        if (stamp) stamp[jj * kPhases + 5] = global_ns();
    }
    // no CTA leaves, or rewrites its rows, while another may still read
    // its shared memory
    cluster.sync();

    // epilogue: T_i = P_i / s_i, G_i = H_i / s_i; one inverse per row
    for (int r = tid; r < nloc; r += nthr)
        cl[r] = sl[r] == 1 ? 1 : inv_mod(mod, sl[r], p);
    __syncthreads();
    for (int r = warp; r < nloc; r += nwarps) {
        const int si = cl[r];
        const size_t off = static_cast<size_t>(r) * ld;
        int32_t* pd = P + static_cast<size_t>(row0 + r) * c;
        int32_t* gd = G + static_cast<size_t>(row0 + r) * c;
        for (int t = lane; t < c; t += 32) {
            const int x = Pl[off + t], h = Hl[off + t];
            pd[t] = si == 1 ? x : mod.mul(x, si);
            gd[t] = si == 1 ? h : mod.mul(h, si);
        }
    }
    if (in_smem)
        for (int r = tid; r < nloc; r += nthr) ispiv[row0 + r] = il[r];
}

template <class Mod, int V>
cudaError_t launch(int32_t* P, int32_t* G, uint8_t* ispiv,
                   int32_t* scr, int32_t* prow, int32_t* pcol,
                   uint8_t* pfound, int n, int c, int j0, int npivcols,
                   long long p, Mod mod, long long* stamps,
                   const uint8_t* run, cudaStream_t stream) {
    auto kern = panel_cluster_kernel<Mod, V>;
    const int rpc = n > 0 ? (n + kCluster - 1) / kCluster : 1;
    const size_t c4 = (static_cast<size_t>(c) + 3) & ~size_t{3};
    const size_t rpc4 = (static_cast<size_t>(rpc) + 3) & ~size_t{3};
    const size_t stage = 2 * c4 * sizeof(int32_t);
    const size_t rows = (2 * static_cast<size_t>(rpc)
                         * smem_row_stride(static_cast<int>(c4))
                         + 2 * rpc4) * sizeof(int32_t) + rpc4;
    const int in_smem = stage + rows <= kSmemCap;
    const size_t smem = in_smem ? stage + rows : stage;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // the residency query is made outside a stream capture only: a graph
    // is captured after an eager run of the same shapes has made it
    cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &capturing);
    if (err != cudaSuccess) return err;
    if (capturing == cudaStreamCaptureStatusNone) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
        if (err != cudaSuccess) return err;
        if (clusters < 1) return cudaErrorLaunchOutOfResources;
    }
    err = cudaLaunchKernelEx(&cfg, kern, P, G, ispiv, scr, prow, pcol,
                             pfound, n, c, j0, npivcols, p, mod, rpc,
                             in_smem, stamps, run);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <class Mod>
cudaError_t launch_mod(int vec4, int32_t* P, int32_t* G,
                       uint8_t* ispiv, int32_t* scr, int32_t* prow,
                       int32_t* pcol, uint8_t* pfound, int n, int c, int j0,
                       int npivcols, long long p, Mod mod,
                       long long* stamps, const uint8_t* run,
                       cudaStream_t stream) {
    return vec4 ? launch<Mod, 4>(P, G, ispiv, scr, prow, pcol, pfound, n,
                                 c, j0, npivcols, p, mod, stamps, run,
                                 stream)
                : launch<Mod, 1>(P, G, ispiv, scr, prow, pcol, pfound, n,
                                 c, j0, npivcols, p, mod, stamps, run,
                                 stream);
}

}  // namespace

// P and G: contiguous (n, c) int32, G zeroed; scr: int32 scratch of 2n
// entries (the scales and the pivot column where the rows live in global
// memory).  stamps: null, or int64 of c * kPhases entries, zeroed (see
// above).  run: null, or a one-byte device flag; where it reads 0 the
// kernel does nothing (prow, pcol, pfound zeroed by the caller).  Returns
// cudaErrorLaunchOutOfResources where no cluster of kCluster CTAs can be
// resident.
extern "C" int spasm_panel_eliminate(void* P, void* G, void* ispiv,
                                     void* scr, void* prow, void* pcol,
                                     void* pfound, int n, int c, int j0,
                                     int npivcols, long long p, void* stamps,
                                     const void* run, void* stream) {
    auto* go = static_cast<const uint8_t*>(run);
    if (n < 0 || c <= 0 || c > 4096)
        return static_cast<int>(cudaErrorInvalidValue);
    const int vec4 = (c % 4 == 0)
        && reinterpret_cast<uintptr_t>(P) % 16 == 0
        && reinterpret_cast<uintptr_t>(G) % 16 == 0;
    auto* Pi = static_cast<int32_t*>(P);
    auto* Gi = static_cast<int32_t*>(G);
    auto* Ii = static_cast<uint8_t*>(ispiv);
    auto* Si = static_cast<int32_t*>(scr);
    auto* pr = static_cast<int32_t*>(prow);
    auto* pc = static_cast<int32_t*>(pcol);
    auto* pf = static_cast<uint8_t*>(pfound);
    auto* ts = static_cast<long long*>(stamps);
    auto st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = p <= 65535
        ? launch_mod(vec4, Pi, Gi, Ii, Si, pr, pc, pf, n, c, j0, npivcols, p,
                     ModSmall{static_cast<int>(p),
                              1.0f / static_cast<float>(p)}, ts, go, st)
        : launch_mod(vec4, Pi, Gi, Ii, Si, pr, pc, pf, n, c, j0, npivcols, p,
                     ModWide{p, 1.0 / static_cast<double>(p)}, ts, go, st);
    return static_cast<int>(err);
}
