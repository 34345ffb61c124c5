/* Full mutual reduction (block RREF) of an ordered pivot block over GF(p).
 *
 * Input: the round's pivot block W (CSR, rows sorted ASCENDING by
 * elimination level, unit pivots), qinv[j] = level-sorted row index owning
 * column j (or -1), and the level offsets offs[0..depth].  Output: W* in
 * the same row order where every row has zero at every OTHER pivot's
 * column.
 *
 * Algorithm: each row is finalized EXACTLY ONCE.  Because a finalized row
 * k has zeros at all pivot columns except its own, the reduced form of row
 * i is
 *
 *     final_i = row_i - sum_{original hits j: k = qinv[j], k != i}
 *                       W[i,j] * final_k
 *
 * using only row i's ORIGINAL hits -- no cascade: the cascade is absorbed
 * by the finality of the referenced rows, and the block RREF is unique, so
 * this matches the backward per-level sweep (schur_mod.c ranged variant)
 * bit for bit.  Every hit k of row i has level(k) > level(i) (that is the
 * level definition), so processing levels in DESCENDING order makes all
 * referenced rows final before they are read.  The old sweep rewrote the
 * whole prefix once per level -- O(depth * nnz) memory traffic; this
 * kernel writes each output row once (this was the largest single wall of
 * the d9 headline bench, ~1.0 s of 2.9 s).
 *
 * Parallelism: rows within a level are independent (per-thread contiguous
 * ranges balanced by estimated work, per-row sparse accumulator with stamp
 * marking, per-(level,thread) output buffers stitched once at the end).
 *
 * Exactness: as in schur_mod.c -- with reduce_each = 0 the caller
 * guarantees (terms per output) * (p/2)^2 < 2^62, where terms per output
 * <= 1 + max row nnz of W (each referenced final row contributes one
 * product per column).  Returns total output nnz, -1 on allocation
 * failure, -2 when the running output nnz exceeds nnz_cap (fill blow-up;
 * caller falls back).  This is the native engine of
 * elimination.py:mutual_reduce (reference role: the repeated
 * spasm_schur/scatter passes of src/SpaSM.jl:619-621,758-770).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* race-free read of the shared early-exit flag (it is written with
 * `omp atomic write`; a plain read would be a formal C data race) */
static inline int flag_read(const int *p) {
    int v;
#ifdef _OPENMP
#pragma omp atomic read
    v = *p;
#else
    v = *p;
#endif
    return v;
}

static inline int64_t balanced(int64_t x, int64_t P, int64_t halfp) {
    int64_t r = x % P;
    if (r > halfp)
        r -= P;
    else if (r < halfp - P + 1)
        r += P;
    return r;
}

/* each csrc module builds as its own shared library (native.py _build),
 * so the free/cmp helpers are defined here too */
void spasm_tpu_mr_free(void *p) { free(p); }

static int cmp_i32_mr(const void *a, const void *b)
{
    int32_t x = *(const int32_t *)a, y = *(const int32_t *)b;
    return (x > y) - (x < y);
}

/* nearly-sorted input (concatenated sorted runs) — see schur_mod.c */
static inline void sort_touched_mr(int32_t *a, int64_t n)
{
    if (n <= 512) {
        for (int64_t i = 1; i < n; i++) {
            int32_t v = a[i];
            int64_t j = i - 1;
            while (j >= 0 && a[j] > v) {
                a[j + 1] = a[j];
                j--;
            }
            a[j + 1] = v;
        }
        return;
    }
    qsort(a, (size_t) n, sizeof(int32_t), cmp_i32_mr);
}

/* rowperm (optional, NULL = identity): level-sorted position i reads
 * input row rowperm[i], and the output CSR is emitted in ORIGINAL row
 * order — the caller never materializes the level-sorted gather nor the
 * inverse-permutation gather of the (bigger) result. */
int64_t spasm_tpu_mutual_reduce(
    int64_t r, int64_t m, int64_t P, int64_t reduce_each,
    const int64_t *Wp, const int32_t *Wj, const int64_t *Wx,
    const int64_t *qinv, const int64_t *offs, int64_t depth,
    int64_t nnz_cap, const int64_t *rowperm,
    int64_t *outp, int32_t **out_j_ret, int64_t **out_x_ret)
{
#define MR_ROW(i) (rowperm ? rowperm[(i)] : (i))
    const int64_t halfp = P / 2;
    if (r == 0 || depth <= 0) {
        outp[0] = 0;
        *out_j_ret = (int32_t *)malloc(sizeof(int32_t));
        *out_x_ret = (int64_t *)malloc(sizeof(int64_t));
        return (*out_j_ret && *out_x_ret) ? 0 : -1;
    }
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > r) nthreads = (int)r;
    if (nthreads < 1) nthreads = 1;
#endif
    /* per-row final storage: pointers + lengths (top level points into W,
     * lower levels into per-(level,thread) buffers kept alive below) */
    const int32_t **fin_j = (const int32_t **)malloc(sizeof(void *) * (size_t)r);
    const int64_t **fin_x = (const int64_t **)malloc(sizeof(void *) * (size_t)r);
    int64_t *fin_len = (int64_t *)malloc(sizeof(int64_t) * (size_t)r);
    /* buffers to free at the end: at most 2 per (level, thread) */
    size_t nbuf_cap = (size_t)(2 * (depth + 1) * nthreads);
    void **bufs = (void **)malloc(sizeof(void *) * nbuf_cap);
    size_t nbuf = 0;
    int64_t *range = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nthreads + 1));
    int64_t *work = NULL;
    int64_t work_cap = 0;
    if (!fin_j || !fin_x || !fin_len || !bufs || !range) {
        free(fin_j); free(fin_x); free(fin_len); free(bufs); free(range);
        return -1;
    }
    /* per-thread buffer registry for the current level */
    int32_t **tjs = (int32_t **)calloc((size_t)nthreads, sizeof(int32_t *));
    int64_t **txs = (int64_t **)calloc((size_t)nthreads, sizeof(int64_t *));
    int64_t *tcap = (int64_t *)malloc(sizeof(int64_t) * (size_t)nthreads);
    if (!tjs || !txs || !tcap) {
        free(fin_j); free(fin_x); free(fin_len); free(bufs); free(range);
        free(tjs); free(txs); free(tcap);
        return -1;
    }

    int64_t total_fin = 0;
    int fail = 0, capped = 0;

    /* top level: final as-is (no row can hit a later pivot's column) */
    {
        int64_t lo = offs[depth - 1], hi = offs[depth];
        for (int64_t i = lo; i < hi; i++) {
            int64_t o = MR_ROW(i);
            fin_j[i] = Wj + Wp[o];
            fin_x[i] = Wx + Wp[o];
            fin_len[i] = Wp[o + 1] - Wp[o];
            total_fin += fin_len[i];
        }
    }

    /* persistent per-thread SPA (allocated once, reused across levels);
     * value + stamp interleaved in one 16-byte cell: a random column
     * update touches ONE cache line instead of two */
    typedef struct { int64_t val; int64_t stamp; } mr_cell;
    mr_cell **spa_c = (mr_cell **)calloc((size_t)nthreads, sizeof(mr_cell *));
    int32_t **spa_t = (int32_t **)calloc((size_t)nthreads, sizeof(int32_t *));
    if (!spa_c || !spa_t) fail = 1;

    for (int64_t t = depth - 2; t >= 0 && !fail && !capped; t--) {
        int64_t lo = offs[t], hi = offs[t + 1];
        int64_t nrow = hi - lo;
        if (nrow <= 0) continue;
        /* work estimate per row of this level */
        if (nrow + 1 > work_cap) {
            free(work);
            work_cap = nrow + 1;
            work = (int64_t *)malloc(sizeof(int64_t) * (size_t)work_cap);
            if (!work) { fail = 1; break; }
        }
        /* per-row work in parallel (random qinv/fin_len lookups), then a
         * serial O(nrow) prefix */
        work[0] = 0;
#pragma omp parallel for schedule(static) num_threads(nthreads)
        for (int64_t i = lo; i < hi; i++) {
            int64_t o = MR_ROW(i);
            int64_t w = Wp[o + 1] - Wp[o];
            for (int64_t e = Wp[o]; e < Wp[o + 1]; e++) {
                int64_t k = qinv[Wj[e]];
                if (k >= 0 && k != i)
                    w += fin_len[k];
            }
            work[i - lo + 1] = w + 1;
        }
        for (int64_t i = 0; i < nrow; i++)
            work[i + 1] += work[i];
        int64_t total_work = work[nrow];
        int nth = nthreads;
        if ((int64_t)nth > nrow) nth = (int)nrow;
        range[0] = 0;
        for (int tt = 1; tt < nth; tt++) {
            int64_t target = total_work * tt / nth;
            int64_t a = range[tt - 1], b = nrow;
            while (a < b) {
                int64_t mid = (a + b) / 2;
                if (work[mid] < target) a = mid + 1; else b = mid;
            }
            range[tt] = a;
        }
        range[nth] = nrow;

        /* chunk loop (see schur_mod.c): correct for any delivered
         * thread count; spa_c/tjs/txs/tcap are indexed by CHUNK, and a
         * chunk's SPA persists across levels (stale stamps are higher
         * global row indices — levels descend, so no collision) */
#pragma omp parallel for schedule(dynamic) num_threads(nth)
        for (int tid = 0; tid < nth; tid++) {
            if (!flag_read(&fail)) {
                if (!spa_c[tid]) {
                    spa_c[tid] = (mr_cell *)malloc(sizeof(mr_cell) * (size_t)m);
                    spa_t[tid] = (int32_t *)malloc(sizeof(int32_t) * (size_t)m);
                    if (!spa_c[tid] || !spa_t[tid]) {
#pragma omp atomic write
                        fail = 1;
                    } else {
                        for (int64_t j = 0; j < m; j++)
                            spa_c[tid][j].stamp = -1;
                    }
                }
            }
            if (!flag_read(&fail)) {
                int64_t r0 = lo + range[tid], r1 = lo + range[tid + 1];
                int64_t cap = work[range[tid + 1]] - work[range[tid]] + 16;
                int32_t *oj = (int32_t *)malloc(sizeof(int32_t) * (size_t)cap);
                int64_t *ox = (int64_t *)malloc(sizeof(int64_t) * (size_t)cap);
                if (!oj || !ox) {
                    free(oj); free(ox);
#pragma omp atomic write
                    fail = 1;
                } else {
                    tjs[tid] = oj; txs[tid] = ox;
                    mr_cell *spa = spa_c[tid];
                    int32_t *touched = spa_t[tid];
                    int64_t nout = 0;
                    for (int64_t i = r0; i < r1; i++) {
                        int64_t o = MR_ROW(i);
                        int64_t ntouch = 0;
                        for (int64_t e = Wp[o]; e < Wp[o + 1]; e++) {
                            int32_t j = Wj[e];
                            if (spa[j].stamp != i) {
                                spa[j].stamp = i; spa[j].val = 0;
                                touched[ntouch++] = j;
                            }
                            spa[j].val += Wx[e];
                        }
                        for (int64_t e = Wp[o]; e < Wp[o + 1]; e++) {
                            int64_t k = qinv[Wj[e]];
                            if (k < 0 || k == i)
                                continue;
                            int64_t c = Wx[e];
                            const int32_t *kj = fin_j[k];
                            const int64_t *kx = fin_x[k];
                            int64_t kl = fin_len[k];
                            if (reduce_each) {
                                for (int64_t u = 0; u < kl; u++) {
                                    int32_t j = kj[u];
                                    if (spa[j].stamp != i) {
                                        spa[j].stamp = i; spa[j].val = 0;
                                        touched[ntouch++] = j;
                                    }
                                    spa[j].val = balanced(
                                        spa[j].val - c * kx[u], P, halfp);
                                }
                            } else {
                                for (int64_t u = 0; u < kl; u++) {
                                    int32_t j = kj[u];
                                    if (spa[j].stamp != i) {
                                        spa[j].stamp = i; spa[j].val = 0;
                                        touched[ntouch++] = j;
                                    }
                                    spa[j].val -= c * kx[u];
                                }
                            }
                        }
                        if (ntouch > 1)
                            sort_touched_mr(touched, ntouch);
                        int64_t row_start = nout;
                        fin_j[i] = oj + nout;
                        fin_x[i] = ox + nout;
                        for (int64_t e = 0; e < ntouch; e++) {
                            int32_t j = touched[e];
                            int64_t v = balanced(spa[j].val, P, halfp);
                            if (v) { oj[nout] = j; ox[nout] = v; nout++; }
                        }
                        fin_len[i] = nout - row_start;
                    }
                    tcap[tid] = nout;
                }
            }
        } /* end parallel */
        if (fail) break;
        for (int tt = 0; tt < nth; tt++) {
            if (tjs[tt]) { bufs[nbuf++] = tjs[tt]; tjs[tt] = NULL; }
            if (txs[tt]) { bufs[nbuf++] = txs[tt]; txs[tt] = NULL; }
            total_fin += tcap[tt];
        }
        if (nnz_cap > 0 && total_fin > nnz_cap)
            capped = 1;
    }

    int64_t result;
    if (fail) {
        result = -1;
    } else if (capped) {
        result = -2;
    } else {
        /* assemble output CSR in ORIGINAL row order (rowperm maps
         * level-sorted position -> original row) */
        outp[0] = 0;
        for (int64_t i = 0; i < r; i++)
            outp[MR_ROW(i) + 1] = fin_len[i];
        for (int64_t i = 0; i < r; i++)
            outp[i + 1] += outp[i];
        int64_t total = outp[r];
        int32_t *all_j = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
        int64_t *all_x = (int64_t *)malloc(sizeof(int64_t) * (size_t)(total ? total : 1));
        if (!all_j || !all_x) {
            free(all_j); free(all_x);
            result = -1;
        } else {
#pragma omp parallel for schedule(static) num_threads(nthreads)
            for (int64_t i = 0; i < r; i++) {
                int64_t o = MR_ROW(i);
                if (fin_len[i]) {
                    memcpy(all_j + outp[o], fin_j[i],
                           sizeof(int32_t) * (size_t)fin_len[i]);
                    memcpy(all_x + outp[o], fin_x[i],
                           sizeof(int64_t) * (size_t)fin_len[i]);
                }
            }
            *out_j_ret = all_j;
            *out_x_ret = all_x;
            result = total;
        }
    }
    for (size_t b = 0; b < nbuf; b++) free(bufs[b]);
    for (int tt = 0; tt < nthreads; tt++) {
        free(tjs[tt]); free(txs[tt]);
        if (spa_c) free(spa_c[tt]);
        if (spa_t) free(spa_t[tt]);
    }
    free(spa_c); free(spa_t);
    free(tjs); free(txs); free(tcap);
    free(fin_j); free(fin_x); free(fin_len);
    free(bufs); free(range); free(work);
    return result;
}
