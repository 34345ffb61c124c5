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
// slots are never written.
//
// Its work on the H100 (not profiled yet): the bitonic network's
// log2(Wp) * (log2(Wp) + 1) / 2 compare-exchange stages over every slot in
// shared memory, with a barrier between stages, against one device-memory
// read and write per slot.  The TPU kernel sorted rows along the lanes of
// VMEM tiles; here the row lives in shared memory and the CTA's threads
// share the network.  Three variants, by Wp:
//   * Wp <= kTileSlots: one CTA sorts kTileSlots / Wp whole rows side by
//     side (32 KiB of shared memory, several CTAs per SM);
//   * Wp <= kMaxSmemSlots: one CTA, one row, up to 128 KiB of dynamic
//     shared memory (opt-in above 48 KiB);
//   * wider (accepted up to 2**30, checked up to 2**20): one CTA per row
//     at a time over a global-memory copy of the row: kChunk-slot chunks
//     are sorted in shared memory, the merge stages with a stride of a
//     chunk or more run on global memory, the shorter ones again chunk by
//     chunk in shared memory, and the scan walks the chunks in order with
//     a carry.
// Register-level and warp-shuffle stages, and sorting only the live width
// of wide rows, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kPad = ~0ull;            // sorts after every real key
constexpr int kThreads = 512;          // narrow and single-row variants
constexpr int kWideThreads = 1024;     // wide variant
constexpr int kTileSlots = 4096;       // slots of one CTA, narrow rows
constexpr int kMaxSmemSlots = 16384;   // widest row kept whole in smem
constexpr int kChunk = 16384;          // wide rows: slots per smem chunk

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

struct Out {
    int32_t* cols;
    int32_t* vals;
    uint8_t* keep;
    long long R;
    int W, m;
};

// Segmented inclusive scan of the sorted span s[0..n) (n a multiple of
// blockDim.x) and the write of its outputs.  Slot i is row-local position
// (base + i) & wmask of row row0 + ((base + i) >> logw).  prev_col /
// prev_val: the column and inclusive sum of the slot before s[0] in its row
// (-1 / 0 at a row start); next_col: the column of the slot after s[n-1]
// (unused when s[n-1] ends its row).  Returns, in *carry, the inclusive
// sum at s[n-1].
__device__ void scan_write(const u64* s, int n, int base, int wmask,
                           int logw, long long row0, int32_t prev_col,
                           long long prev_val, int32_t next_col, long long p,
                           const Out& o, long long* carry) {
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
        const int i = i0 + u;
        const u64 kk = s[i];
        const int32_t c = key_col(kk);
        const bool start = ((base + i) & wmask) == 0 || c != pc;
        v = start ? key_val(kk) : add_mod(v, key_val(kk), p);
        fl |= start;
        pc = c;
    }
    if (tid == 0 && !fl) v = add_mod(prev_val, v, p);  // the carry in
    // inclusive warp scan of (flag, sum): (f1, v1) + (f2, v2) =
    // (f1 | f2, f2 ? v2 : v1 + v2)
    for (int d = 1; d < 32; d <<= 1) {
        const int f2 = __shfl_up_sync(0xffffffffu, fl, d);
        const long long v2 = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) {
            if (!fl) v = add_mod(v2, v, p);
            fl |= f2;
        }
    }
    if (lane == 31) {
        wflag[warp] = fl;
        wsum[warp] = v;
    }
    const int fe = __shfl_up_sync(0xffffffffu, fl, 1);
    const long long ve = __shfl_up_sync(0xffffffffu, v, 1);
    __syncthreads();
    if (warp == 0) {
        int f = lane < nwarps ? wflag[lane] : 1;
        long long w = lane < nwarps ? wsum[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int f2 = __shfl_up_sync(0xffffffffu, f, d);
            const long long w2 = __shfl_up_sync(0xffffffffu, w, d);
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
        const int q = base + i;
        const int pos = q & wmask;
        const bool start = pos == 0 || c != pc;
        run = start ? key_val(kk) : add_mod(run, key_val(kk), p);
        const int32_t nc = i + 1 < n ? key_col(s[i + 1]) : next_col;
        const bool last = pos == wmask || nc != c;
        const long long row = row0 + (q >> logw);
        if (row < o.R && pos < o.W) {
            const long long at = row * o.W + pos;
            o.cols[at] = c;
            o.vals[at] = static_cast<int32_t>(run);
            o.keep[at] = last && run != 0 && c < o.m;
        }
        pc = c;
    }
    if (tid == blockDim.x - 1) *carry = run;
    __syncthreads();
}

// Narrow and single-row variants: n = max(kTileSlots, Wp) slots of shared
// memory hold n / Wp whole rows.
__global__ void __launch_bounds__(kThreads)
merge_smem_kernel(const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ vals, Out o, int logw,
                  long long p) {
    extern __shared__ u64 s[];
    __shared__ long long carry;
    const int wp = 1 << logw, wmask = wp - 1;
    const int n = wp > kTileSlots ? wp : kTileSlots;
    const long long row0 = static_cast<long long>(blockIdx.x) * (n >> logw);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const long long row = row0 + (i >> logw);
        const int pos = i & wmask;
        u64 k = kPad;
        if (row < o.R && pos < o.W) {
            const long long at = row * o.W + pos;
            k = make_key(cols[at], vals[at]);
        }
        s[i] = k;
    }
    __syncthreads();
    bitonic_sort(s, n, 0, wmask, wp);
    scan_write(s, n, 0, wmask, logw, row0, -1, 0, -1, p, o, &carry);
}

// Wide variant: each CTA takes rows blockIdx.x, + gridDim.x, ... and sorts
// each in its own Wp-slot row of the global scratch g.
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
            scan_write(s, kChunk, base, wmask, logw, row, prev_col,
                       prev_val, next_col, p, o, &carry);
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
    cudaError_t err;
    if (wp <= kMaxSmemSlots) {
        const int n = wp > kTileSlots ? wp : kTileSlots;
        const size_t smem = static_cast<size_t>(n) * sizeof(u64);
        err = cudaFuncSetAttribute(merge_smem_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const long long rpc = n >> logw;
        const long long grid = (R + rpc - 1) / rpc;
        if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
        merge_smem_kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
            c, v, o, logw, p);
    } else {
        if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        const size_t smem = static_cast<size_t>(kChunk) * sizeof(u64);
        err = cudaFuncSetAttribute(merge_wide_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        const long long grid = spasm_merge_scratch_rows(R, W, nsm);
        merge_wide_kernel<<<static_cast<unsigned>(grid), kWideThreads, smem,
                            st>>>(c, v, o, static_cast<u64*>(scratch), logw,
                                  p);
    }
    return static_cast<int>(cudaGetLastError());
}
