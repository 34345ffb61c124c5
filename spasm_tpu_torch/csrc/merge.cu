// K3: the per-row merge of the device sparse Schur update over GF(p).
//
// Replaces spasm_tpu/ops/pallas_merge.py::_merge_kernel_body (launched by
// merge_rows_pallas).  For every row of an (R, W) tile of (col, val) int32
// contributions (0 <= col <= m < 2**31, balanced values, col == m marks a
// dead slot) it
//   1. sorts the row by the 64-bit key (col, val as uint32): ties are
//      identical entries, so the sorted row is unique and the plain version
//      (spasm_tpu_torch/ops/merge.py::merge_rows_plain, torch.sort on the
//      same key) gives the same bits in all three outputs;
//   2. runs a segmented inclusive sum mod p over runs of equal columns
//      (pairwise balanced adds in int64 with one fold: exact for every
//      p <= 0xFFFFFFFB);
//   3. flags keep = last slot of its run && sum != 0 && col < m.
// The row is padded to Wp = 2**ceil(log2 W) inside the kernel with a key
// that sorts after every real one, so the caller pads nothing; the padded
// slots are never read from or written to device memory.
//
// Rows of Wp <= kMaxSmemSlots (every width the one-pass path has made)
// go to merge_rows_kernel<E>, a bitonic network on keys held in
// registers.  A row is T = Wp / E lanes, each holding E = min(Wp /
// kMinRowLanes, kKeysPerLane) keys; sorted, lane t holds slots t E .. t E
// + E - 1 (blocked layout).  Rows of T <= 32 lanes share a warp (32 / T
// rows a warp: 16 at Wt 32, 2 at Wt 272); wider rows take one CTA of T
// threads.  A stage (k, j) runs at one of three levels:
//   * j < E: a compare-exchange between two registers of the lane;
//   * E <= j < 32 E: __shfl_xor_sync of the 64-bit key with lane t ^ j/E,
//     each lane keeping the min or the max;
//   * j >= 32 E (rows over 32 E slots only): the same exchange through
//     shared memory in the striped layout (slot of lane t, register e at
//     e * T + t: conflict-free), between two CTA barriers.
// The network sorts its input in any order, so the loads take the one
// that coalesces over a row's lanes (16-byte loads where W % 16 == 0);
// the stores write each lane's E slots, 16 bytes at a time.  The scan runs
// on the registers: each lane sums its E slots, a segmented shuffle scan
// of (run started?, sum) crosses the lanes, one shared-memory carry the
// warps, and a second pass writes the outputs.
//
// What bounds it on the H100 (PERF.md): instruction issue.  A
// compare-exchange of two 64-bit keys is two integer compares and four
// selects; the selects go to the FP32 pipe (FSEL, pick()), since the
// integer pipe has half its lanes.  At Wt 272 the network (45 stages on
// the row padded to 512) takes about two thirds of the time, the loads,
// scan and stores the rest.
//
// Rows wider than kMaxSmemSlots (accepted up to 2**30, checked up to
// 2**20; no workload yet) take merge_wide_kernel: one CTA per row at a
// time over a global-memory copy of the row: kChunk-slot chunks are sorted
// in shared memory, the merge stages with a stride of a chunk or more run
// on global memory, the shorter ones again chunk by chunk in shared
// memory, and the scan walks the chunks in order with a carry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kPad = ~0ull;            // sorts after every real key
// the register kernel's layout (mirrored by
// tests/test_torch_merge_network.py, which reads these four lines)
constexpr int kKeysPerLane = 32;       // E of rows of Wp >= 64
constexpr int kMinRowLanes = 2;        // T of narrower rows (E = Wp / 2)
constexpr int kCtaThreads = 128;       // CTA of rows of T <= 32 lanes
constexpr int kMaxSmemSlots = 16384;   // widest row of the register kernel
constexpr int kMaxRowThreads = kMaxSmemSlots / kKeysPerLane;
constexpr int kWideThreads = 1024;     // wide variant
constexpr int kChunk = 16384;          // wide rows: slots per smem chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u64 make_key(int32_t col, int32_t val) {
    return (static_cast<u64>(static_cast<uint32_t>(col)) << 32)
        | static_cast<uint32_t>(val);
}
__device__ __forceinline__ int32_t key_col(u64 k) {
    return static_cast<int32_t>(k >> 32);     // -1 for the padding key
}
__device__ __forceinline__ long long key_val(u64 k) {
    return static_cast<int32_t>(static_cast<uint32_t>(k));
}

// a + b mod p for balanced a, b: |a + b| <= p - 1, one fold
__device__ __forceinline__ long long add_mod(long long a, long long b,
                                             long long p) {
    long long s = a + b;
    const long long half = p >> 1;
    if (s > half) s -= p;
    else if (s < -half) s += p;
    return s;
}

struct Out {
    int32_t* cols;
    int32_t* vals;
    uint8_t* keep;
    long long R;
    int W, m;
};

// ---------------------------------------------------------------------
// The register kernel (Wp <= kMaxSmemSlots)

// p ? a : b, selected as two 32-bit halves typed float: selp.f32 becomes
// FSEL on the FP32 pipe, which has twice the integer pipe's lanes on the
// H100 (a 64-bit integer select is two SELs of the integer pipe, like the
// two compares beside it); the bits pass through unchanged
__device__ __forceinline__ float fsel(bool p, uint32_t a, uint32_t b) {
    float r;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
        "selp.f32 %0, %1, %2, q;\n\t}"
        : "=f"(r)
        : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)),
          "r"(static_cast<int>(p)));
    return r;
}
__device__ __forceinline__ u64 pick(bool p, u64 a, u64 b) {
    const float lo =
        fsel(p, static_cast<uint32_t>(a), static_cast<uint32_t>(b));
    const float hi = fsel(p, static_cast<uint32_t>(a >> 32),
                          static_cast<uint32_t>(b >> 32));
    return (static_cast<u64>(__float_as_uint(hi)) << 32) | __float_as_uint(lo);
}

// a holds the lower slot; after it, a <= b when asc, a >= b otherwise
__device__ __forceinline__ void cas(u64& a, u64& b, bool asc) {
    const bool swap = (a > b) == asc;
    const u64 lo = pick(swap, b, a), hi = pick(swap, a, b);
    a = lo;
    b = hi;
}

// The register stages (j = E/2 .. 1) of a merge whose block holds the
// whole lane and sorts ascending iff asc.
template <int E>
__device__ __forceinline__ void lane_merge(u64 (&x)[E], bool asc) {
#pragma unroll
    for (int j = E >> 1; j > 0; j >>= 1)
#pragma unroll
        for (int e = 0; e < E; ++e)
            if ((e & j) == 0) cas(x[e], x[e | j], asc);
}

// byte i of the result is bit i of b (b < 16)
__device__ __forceinline__ uint32_t bytes_of_bits(uint32_t b) {
    return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// One row of Wp = 2**logw slots is T = Wp / E lanes; a CTA holds
// kCtaThreads / T rows of T <= 32 lanes, or one row of T > 32 (the
// shared-memory row of its cross-warp stages).  vec: W % 16 == 0 and
// every pointer 16-byte aligned (16-byte accesses where E >= 16).
template <int E>
__global__ void __launch_bounds__(kMaxRowThreads)
merge_rows_kernel(const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ vals, Out o, int logw,
                  bool vec, long long p) {
    extern __shared__ u64 xs[];                 // rows of T > 32 only
    __shared__ int32_t edge[2][kMaxRowThreads / 32];
    __shared__ int wflag[kMaxRowThreads / 32];
    __shared__ long long wsum[kMaxRowThreads / 32];
    const int wp = 1 << logw;
    const int T = wp / E;                       // lanes of a row
    const int rpc = T <= 32 ? kCtaThreads / T : 1;
    const long long row =
        static_cast<long long>(blockIdx.x) * rpc + threadIdx.x / T;
    const int t = threadIdx.x & (T - 1);
    const int seg = T < 32 ? T : 32;            // lanes of a row in a warp
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ts = lane & (seg - 1);

    // The network sorts the row's slots in any order, so the loads take
    // the one that coalesces over the row's lanes: lane t reads 16-byte
    // group i T + t into x[4 i .. 4 i + 3] (W % 16 == 0), else slot e T + t
    // into x[e].  The sorted row comes out blocked.
    const long long rbase = row * o.W;
    const int wr = row < o.R ? o.W : 0;         // real slots of this row
    u64 x[E];
    if constexpr (E >= 16) {
        if (vec) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
                const int s = e * T + 4 * t;
                if (s < wr) {
                    const int4 c =
                        *reinterpret_cast<const int4*>(cols + rbase + s);
                    const int4 v =
                        *reinterpret_cast<const int4*>(vals + rbase + s);
                    x[e] = make_key(c.x, v.x);
                    x[e + 1] = make_key(c.y, v.y);
                    x[e + 2] = make_key(c.z, v.z);
                    x[e + 3] = make_key(c.w, v.w);
                } else {
                    x[e] = x[e + 1] = x[e + 2] = x[e + 3] = kPad;
                }
            }
        }
    }
    if (!(E >= 16 && vec)) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int s = e * T + t;
            x[e] = s < wr ? make_key(cols[rbase + s], vals[rbase + s]) : kPad;
        }
    }

    // blocks of up to E slots: in registers (a block of k < E slots sorts
    // ascending iff bit k of e is clear, the block of E iff bit E of t * E)
#pragma unroll
    for (int k = 2; k < E; k <<= 1)
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
            for (int e = 0; e < E; ++e)
                if ((e & j) == 0) cas(x[e], x[e | j], (e & k) == 0);
    lane_merge<E>(x, ((t * E) & E) == 0);
    // blocks of 2E .. Wp: the stages across lanes, then those in registers
    for (int k = 2 * E; k <= wp; k <<= 1) {
        const bool asc = ((t * E) & k) == 0;
        for (int j = k >> 1; j >= E; j >>= 1) {
            const int d = j / E;                // partner lane t ^ d
            const bool take_max = ((t & d) != 0) == asc;
            if (d < 32) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const u64 y = __shfl_xor_sync(kFull, x[e], d);
                    x[e] = pick((x[e] > y) == take_max, x[e], y);
                }
            } else {                            // T > 32: the whole CTA
                __syncthreads();
#pragma unroll
                for (int e = 0; e < E; ++e) xs[e * T + t] = x[e];
                __syncthreads();
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const u64 y = xs[e * T + (t ^ d)];
                    x[e] = pick((x[e] > y) == take_max, x[e], y);
                }
            }
        }
        lane_merge<E>(x, asc);
    }

    // the columns next to this lane's slots (-1 past the row's ends)
    const int32_t first = key_col(x[0]), last = key_col(x[E - 1]);
    int32_t prevc = __shfl_up_sync(kFull, last, 1, seg);
    int32_t nextc = __shfl_down_sync(kFull, first, 1, seg);
    if (T > 32) {
        if (lane == 0) edge[0][warp] = first;
        if (lane == 31) edge[1][warp] = last;
        __syncthreads();
        if (lane == 0 && t > 0) prevc = edge[1][warp - 1];
        if (lane == 31 && t < T - 1) nextc = edge[0][warp + 1];
    }
    if (t == 0) prevc = -1;
    if (t == T - 1) nextc = -1;

    // this lane's aggregate: (a run started in it?, sum since the last
    // start), then the inclusive scan of it over the row's lanes:
    // (f1, v1) + (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2)
    int fl = 0;
    long long v = 0;
    int32_t pc = prevc;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int32_t c = key_col(x[e]);
        const bool start = c != pc;
        v = start ? key_val(x[e]) : add_mod(v, key_val(x[e]), p);
        fl |= start;
        pc = c;
    }
    for (int d = 1; d < seg; d <<= 1) {
        const int f2 = __shfl_up_sync(kFull, fl, d, seg);
        const long long v2 = __shfl_up_sync(kFull, v, d, seg);
        if (ts >= d) {
            if (!fl) v = add_mod(v2, v, p);
            fl |= f2;
        }
    }
    // the inclusive sum at the slot before this lane's first
    const int fe = __shfl_up_sync(kFull, fl, 1, seg);
    long long run = __shfl_up_sync(kFull, v, 1, seg);
    if (T > 32) {
        if (lane == 31) {
            wflag[warp] = fl;
            wsum[warp] = v;
        }
        __syncthreads();
        long long wv = 0;                       // at the end of warp - 1
        for (int u = 0; u < warp; ++u)
            wv = wflag[u] ? wsum[u] : add_mod(wv, wsum[u], p);
        run = ts == 0 ? wv : (fe ? run : add_mod(wv, run, p));
    }
    // the sums and flags; x[e] becomes (col, sum)
    uint32_t kbits = 0;
    pc = prevc;
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int32_t c = key_col(x[e]);
        run = c != pc ? key_val(x[e]) : add_mod(run, key_val(x[e]), p);
        const int32_t nc = e + 1 < E ? key_col(x[e + 1]) : nextc;
        kbits |= static_cast<uint32_t>(nc != c && run != 0 && c < o.m) << e;
        x[e] = make_key(c, static_cast<int32_t>(run));
        pc = c;
    }
    // the stores: this lane's real slots (none past the row's end or the
    // tile's) from slot t E on
    const int n = row < o.R ? o.W - t * E : 0;
    const long long at = row * o.W + static_cast<long long>(t) * E;
    if constexpr (E >= 16) {
        if (vec) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
                if (e < n) {
                    *reinterpret_cast<int4*>(o.cols + at + e) = make_int4(
                        key_col(x[e]), key_col(x[e + 1]), key_col(x[e + 2]),
                        key_col(x[e + 3]));
                    *reinterpret_cast<int4*>(o.vals + at + e) = make_int4(
                        static_cast<int32_t>(x[e]),
                        static_cast<int32_t>(x[e + 1]),
                        static_cast<int32_t>(x[e + 2]),
                        static_cast<int32_t>(x[e + 3]));
                }
            }
#pragma unroll
            for (int e = 0; e < E; e += 16) {
                if (e < n) {
                    const uint32_t b = kbits >> e;
                    *reinterpret_cast<uint4*>(o.keep + at + e) = make_uint4(
                        bytes_of_bits(b & 15u), bytes_of_bits((b >> 4) & 15u),
                        bytes_of_bits((b >> 8) & 15u),
                        bytes_of_bits((b >> 12) & 15u));
                }
            }
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
        if (e < n) {
            o.cols[at + e] = key_col(x[e]);
            o.vals[at + e] = static_cast<int32_t>(x[e]);
            o.keep[at + e] = (kbits >> e) & 1u;
        }
    }
}

template <int E>
cudaError_t launch_rows(const int32_t* c, const int32_t* v, const Out& o,
                        int logw, bool vec, long long p, cudaStream_t st) {
    const int T = (1 << logw) / E;
    const int threads = T > 32 ? T : kCtaThreads;
    const long long rpc = threads / T;
    const long long grid = (o.R + rpc - 1) / rpc;
    if (grid > 0x7fffffffll) return cudaErrorInvalidValue;
    const size_t smem = T > 32 ? (sizeof(u64) << logw) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            merge_rows_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    merge_rows_kernel<E><<<static_cast<unsigned>(grid), threads, smem, st>>>(
        c, v, o, logw, vec, p);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The wide variant (Wp > kMaxSmemSlots)

// One compare-exchange stage (k, j) over x[0..n): slot i sits at row-local
// position (base + i) & wmask, and the block of size k holding it sorts
// ascending iff that position has bit k clear (always, when k == Wp).
__device__ __forceinline__ void bitonic_stage(u64* x, int n, int base,
                                              int wmask, int k, int j) {
    for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const bool asc = (((base + lo) & wmask) & k) == 0;
        const u64 a = x[lo], b = x[hi];
        if ((a > b) == asc) {
            x[lo] = b;
            x[hi] = a;
        }
    }
}

// Every stage with block size 2..kmax over shared memory s[0..n).
__device__ void bitonic_sort(u64* s, int n, int base, int wmask, int kmax) {
    for (int k = 2; k <= kmax; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
            bitonic_stage(s, n, base, wmask, k, j);
            __syncthreads();
        }
}

// Segmented inclusive scan of the sorted chunk s[0..n) of row `row` (n a
// multiple of blockDim.x) and the write of its outputs.  Slot i is
// position base + i of the row.  prev_col / prev_val: the column and
// inclusive sum of the slot before s[0] (-1 / 0 at the row's start);
// next_col: the column of the slot after s[n-1] (-1 at the row's end).
// Returns, in *carry, the inclusive sum at s[n-1].
__device__ void scan_write(const u64* s, int n, int base, long long row,
                           int32_t prev_col, long long prev_val,
                           int32_t next_col, long long p, const Out& o,
                           long long* carry) {
    __shared__ int wflag[32];
    __shared__ long long wsum[32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int ipt = n / blockDim.x;
    const int i0 = tid * ipt;
    // pass 1: this thread's aggregate (a run started in it?, sum since)
    int fl = 0;
    long long v = 0;
    int32_t pc = i0 == 0 ? prev_col : key_col(s[i0 - 1]);
    for (int u = 0; u < ipt; ++u) {
        const u64 kk = s[i0 + u];
        const int32_t c = key_col(kk);
        const bool start = c != pc;
        v = start ? key_val(kk) : add_mod(v, key_val(kk), p);
        fl |= start;
        pc = c;
    }
    if (tid == 0 && !fl) v = add_mod(prev_val, v, p);  // the carry in
    // inclusive warp scan of (flag, sum): (f1, v1) + (f2, v2) =
    // (f1 | f2, f2 ? v2 : v1 + v2)
    for (int d = 1; d < 32; d <<= 1) {
        const int f2 = __shfl_up_sync(kFull, fl, d);
        const long long v2 = __shfl_up_sync(kFull, v, d);
        if (lane >= d) {
            if (!fl) v = add_mod(v2, v, p);
            fl |= f2;
        }
    }
    if (lane == 31) {
        wflag[warp] = fl;
        wsum[warp] = v;
    }
    const int fe = __shfl_up_sync(kFull, fl, 1);
    const long long ve = __shfl_up_sync(kFull, v, 1);
    __syncthreads();
    if (warp == 0) {
        int f = lane < nwarps ? wflag[lane] : 1;
        long long w = lane < nwarps ? wsum[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int f2 = __shfl_up_sync(kFull, f, d);
            const long long w2 = __shfl_up_sync(kFull, w, d);
            if (lane >= d) {
                if (!f) w = add_mod(w2, w, p);
                f |= f2;
            }
        }
        if (lane < nwarps) wsum[lane] = w;
    }
    __syncthreads();
    // the inclusive sum at slot i0 - 1
    long long run;
    if (lane > 0)
        run = (warp == 0 || fe) ? ve : add_mod(wsum[warp - 1], ve, p);
    else
        run = warp == 0 ? prev_val : wsum[warp - 1];
    // pass 2: the sums, flags and writes
    pc = i0 == 0 ? prev_col : key_col(s[i0 - 1]);
    for (int u = 0; u < ipt; ++u) {
        const int i = i0 + u;
        const u64 kk = s[i];
        const int32_t c = key_col(kk);
        run = c != pc ? key_val(kk) : add_mod(run, key_val(kk), p);
        const int32_t nc = i + 1 < n ? key_col(s[i + 1]) : next_col;
        const int pos = base + i;
        if (pos < o.W) {
            const long long at = row * o.W + pos;
            o.cols[at] = c;
            o.vals[at] = static_cast<int32_t>(run);
            o.keep[at] = nc != c && run != 0 && c < o.m;
        }
        pc = c;
    }
    if (tid == blockDim.x - 1) *carry = run;
    __syncthreads();
}

// Each CTA takes rows blockIdx.x, + gridDim.x, ... and sorts each in its
// own Wp-slot row of the global scratch g.
__global__ void __launch_bounds__(kWideThreads)
merge_wide_kernel(const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ vals, Out o, u64* scratch,
                  int logw, long long p) {
    extern __shared__ u64 s[];
    __shared__ long long carry;
    const int wp = 1 << logw, wmask = wp - 1;
    u64* g = scratch + static_cast<size_t>(blockIdx.x) * wp;
    for (long long row = blockIdx.x; row < o.R; row += gridDim.x) {
        const int32_t* rc = cols + row * o.W;
        const int32_t* rv = vals + row * o.W;
        // 1. every chunk sorted (blocks up to kChunk) in shared memory
        for (int base = 0; base < wp; base += kChunk) {
            for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
                const int pos = base + i;
                s[i] = pos < o.W ? make_key(rc[pos], rv[pos]) : kPad;
            }
            __syncthreads();
            bitonic_sort(s, kChunk, base, wmask, kChunk);
            for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
                g[base + i] = s[i];
            __syncthreads();
        }
        // 2. the merges of blocks 2 * kChunk .. Wp
        for (int k = 2 * kChunk; k <= wp; k <<= 1) {
            for (int j = k >> 1; j >= kChunk; j >>= 1) {
                bitonic_stage(g, wp, 0, wmask, k, j);
                __syncthreads();
            }
            for (int base = 0; base < wp; base += kChunk) {
                for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
                    s[i] = g[base + i];
                __syncthreads();
                for (int j = kChunk >> 1; j > 0; j >>= 1) {
                    bitonic_stage(s, kChunk, base, wmask, k, j);
                    __syncthreads();
                }
                for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
                    g[base + i] = s[i];
                __syncthreads();
            }
        }
        // 3. the scan, chunk by chunk, carrying the run across chunks
        int32_t prev_col = -1;
        long long prev_val = 0;
        for (int base = 0; base < o.W; base += kChunk) {
            for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
                s[i] = g[base + i];
            __syncthreads();
            const int32_t next_col =
                base + kChunk < wp ? key_col(g[base + kChunk]) : -1;
            scan_write(s, kChunk, base, row, prev_col, prev_val, next_col,
                       p, o, &carry);
            prev_col = key_col(s[kChunk - 1]);
            prev_val = carry;
            __syncthreads();  // s is reloaded next
        }
    }
}

int log2_ceil(long long w) {
    int l = 0;
    while ((1ll << l) < w) ++l;
    return l;
}

bool aligned16(const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

}  // namespace

// Rows of int64 scratch the wide variant needs (0 for the others): one
// Wp-slot row per CTA, min(R, nsm) CTAs.
extern "C" long long spasm_merge_scratch_rows(long long R, int W, int nsm) {
    if ((1ll << log2_ceil(W)) <= kMaxSmemSlots) return 0;
    return R < nsm ? R : nsm;
}

// cols, vals: contiguous (R, W) int32 on the device; ocols, ovals (int32)
// and keep (uint8) the same shape; scratch: spasm_merge_scratch_rows rows
// of Wp int64 (may be null when that is 0).  R, W > 0, W <= 2**30.
extern "C" int spasm_merge_rows(const void* cols, const void* vals,
                                void* ocols, void* ovals, void* keep,
                                void* scratch, long long R, int W, int m,
                                long long p, int nsm, void* stream) {
    if (R <= 0 || W <= 0 || W > (1 << 30) || m < 0 || nsm <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int logw = log2_ceil(W);
    const int wp = 1 << logw;
    Out o{static_cast<int32_t*>(ocols), static_cast<int32_t*>(ovals),
          static_cast<uint8_t*>(keep), R, W, m};
    const auto* c = static_cast<const int32_t*>(cols);
    const auto* v = static_cast<const int32_t*>(vals);
    auto st = static_cast<cudaStream_t>(stream);
    if (wp <= kMaxSmemSlots) {
        const bool vec = W % 16 == 0 && aligned16(cols) && aligned16(vals)
            && aligned16(ocols) && aligned16(ovals) && aligned16(keep);
        cudaError_t err;
        const int lanes_e = wp > kMinRowLanes ? wp / kMinRowLanes : 1;
        switch (lanes_e < kKeysPerLane ? lanes_e : kKeysPerLane) {
            case 1: err = launch_rows<1>(c, v, o, logw, vec, p, st); break;
            case 2: err = launch_rows<2>(c, v, o, logw, vec, p, st); break;
            case 4: err = launch_rows<4>(c, v, o, logw, vec, p, st); break;
            case 8: err = launch_rows<8>(c, v, o, logw, vec, p, st); break;
            case 16: err = launch_rows<16>(c, v, o, logw, vec, p, st); break;
            case 32: err = launch_rows<32>(c, v, o, logw, vec, p, st); break;
            default: err = cudaErrorInvalidValue;
        }
        return static_cast<int>(err);
    }
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(kChunk) * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        merge_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = spasm_merge_scratch_rows(R, W, nsm);
    merge_wide_kernel<<<static_cast<unsigned>(grid), kWideThreads, smem, st>>>(
        c, v, o, static_cast<u64*>(scratch), logw, p);
    return static_cast<int>(cudaGetLastError());
}
