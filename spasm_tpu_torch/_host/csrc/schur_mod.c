/* Exact sparse Schur update over GF(p):  D = B - C @ U  (mod p, balanced)
 *
 * The host-side hot loop of the multi-round echelonization: eliminating a
 * row block against a (mutually reduced) pivot block is one fused
 * product-subtract-reduce.  This is the framework's native equivalent of
 * the reference's OpenMP scatter kernel (spasm_scatter.c / spasm_schur.c,
 * see SURVEY.md 2.4) re-designed for our layout: per-row sparse
 * accumulator (SPA) with stamp marking, contiguous per-thread row ranges
 * balanced by nnz, deterministic output (row order preserved).
 *
 * Inputs are CSR with int64 indptr, int32 indices, int64 balanced data
 * (|v| <= p/2).  Output is written into per-thread buffers the function
 * mallocs; the caller copies and frees via spasm_tpu_free().
 *
 * Exactness: the fast path accumulates raw int64 products; it is chosen
 * only when (worst-case terms per output) * (p/2)^2 < 2^62, which the
 * caller guarantees by passing reduce_each = 0 only in that case.  With
 * reduce_each = 1 every axpy is followed by a balanced reduction, keeping
 * |acc| < p + (p/2)^2 <= 2^62 for every legal p <= 2^32 - 5.
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

void spasm_tpu_free(void *p) { free(p); }

int spasm_tpu_cmp_i32(const void *a, const void *b);

/* The touched list is a concatenation of sorted runs (the B row, then
 * each referenced U row), i.e. nearly sorted overall — insertion sort is
 * near-linear on it and beat qsort by ~2x on the d9 Schur kernel even at
 * widths in the hundreds; qsort only guards the quadratic worst case. */
static inline void sort_touched(int32_t *a, int64_t n)
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
    qsort(a, (size_t) n, sizeof(int32_t), spasm_tpu_cmp_i32);
}

/* returns total output nnz, or -1 on allocation failure.
 * outp: (q+1) int64 indptr (filled).
 * out_j / out_x: *one* malloc'd buffer each (caller frees). */
/* interleaved sparse-accumulator cell: value + stamp share one 16-byte
 * slot, so a random column update touches ONE cache line instead of two
 * (separate x[]/stamp[] arrays cost two misses per update — measured
 * ~25% of the d9 headline's Schur kernel wall) */
typedef struct {
    int64_t val;
    int64_t stamp;
} spa_cell;

/* Persistent per-OS-thread SPA arena.  A kernel call on q rows previously
 * malloc'd + stamp-initialized O(m) scratch per thread — ~0.1 s per call
 * at m ~ 3M, which dominated flows made of many SMALL calls (the
 * certificate's 1-row triangular waves: 35 calls).  The arena survives
 * across calls; stamps are never re-initialized because row tags come
 * from a monotonically increasing per-arena counter (a stale stamp from
 * any earlier call is strictly smaller than every new tag).  OpenMP
 * reuses its worker threads across parallel regions, so __thread storage
 * gives each worker a stable private arena. */
typedef struct {
    spa_cell *spa;
    int32_t *touched;
    int64_t cap;
    int64_t next_tag;
} spa_arena;

static __thread spa_arena g_arena = {0, 0, 0, 0};

/* Free every worker thread's arena (best effort: the release parallel
 * region reuses the same OpenMP worker pool as the kernels on this
 * runtime).  The arenas are sized to the largest m ever seen and
 * otherwise retained for the life of the process — call this from
 * long-lived embedders after a one-off huge problem. */
void spasm_tpu_spa_release(void)
{
#pragma omp parallel
    {
        free(g_arena.spa);
        free(g_arena.touched);
        g_arena.spa = NULL;
        g_arena.touched = NULL;
        g_arena.cap = 0;
        g_arena.next_tag = 0;
    }
}

/* returns the SPA (cap >= m) and a fresh tag base for q rows, or NULL on
 * allocation failure.  Stale stamps are < *tag0 by construction. */
static spa_cell *arena_get(int64_t m, int64_t q,
                           int32_t **touched, int64_t *tag0)
{
    if (g_arena.cap < m) {
        free(g_arena.spa);
        free(g_arena.touched);
        g_arena.spa = (spa_cell *)malloc(sizeof(spa_cell) * (size_t)m);
        g_arena.touched = (int32_t *)malloc(sizeof(int32_t) * (size_t)m);
        if (!g_arena.spa || !g_arena.touched) {
            free(g_arena.spa); free(g_arena.touched);
            g_arena.spa = NULL; g_arena.touched = NULL;
            g_arena.cap = 0;
            return NULL;
        }
        g_arena.cap = m;
        g_arena.next_tag = 0;
        for (int64_t j = 0; j < m; j++)
            g_arena.spa[j].stamp = -1;
    }
    *tag0 = g_arena.next_tag;
    g_arena.next_tag += q;
    *touched = g_arena.touched;
    return g_arena.spa;
}

int64_t spasm_tpu_schur_update(
    int64_t q, int64_t m, int64_t P, int64_t reduce_each,
    const int64_t *Bp, const int32_t *Bj, const int64_t *Bx,
    const int64_t *Cp, const int32_t *Cj, const int64_t *Cx,
    const int64_t *Up, const int32_t *Uj, const int64_t *Ux,
    int64_t *outp, int32_t **out_j_ret, int64_t **out_x_ret)
{
    const int64_t halfp = P / 2;
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > q) nthreads = q > 0 ? (int)q : 1;
    if (nthreads < 1) nthreads = 1;
#endif
    /* contiguous row ranges balanced by input work (nnz of B + expanded C) */
    int64_t *work = (int64_t *)malloc(sizeof(int64_t) * (size_t)(q + 1));
    if (!work) return -1;
    work[0] = 0;
    for (int64_t i = 0; i < q; i++) {
        int64_t w = Bp[i + 1] - Bp[i];
        for (int64_t t = Cp[i]; t < Cp[i + 1]; t++) {
            int32_t k = Cj[t];
            w += Up[k + 1] - Up[k];
        }
        work[i + 1] = work[i] + w + 1;
    }
    int64_t total_work = work[q];
    int64_t *range = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nthreads + 1));
    if (!range) { free(work); return -1; }
    range[0] = 0;
    for (int t = 1; t < nthreads; t++) {
        int64_t target = total_work * t / nthreads;
        /* binary search first row with work >= target */
        int64_t lo = range[t - 1], hi = q;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (work[mid] < target) lo = mid + 1; else hi = mid;
        }
        range[t] = lo;
    }
    range[nthreads] = q;
    free(work);

    int32_t **tj = (int32_t **)calloc((size_t)nthreads, sizeof(int32_t *));
    int64_t **tx = (int64_t **)calloc((size_t)nthreads, sizeof(int64_t *));
    int64_t *tn = (int64_t *)calloc((size_t)nthreads, sizeof(int64_t));
    int fail = 0;
    if (!tj || !tx || !tn) fail = 1;

    /* chunk loop, not tid-indexed regions: `omp for` executes every
     * chunk no matter how many threads the runtime actually delivers
     * (OMP_DYNAMIC / thread limits can hand out fewer than requested) */
#pragma omp parallel for schedule(dynamic) num_threads(nthreads)
    for (int tid = 0; tid < nthreads; tid++) {
        if (!flag_read(&fail)) {
            int64_t r0 = range[tid], r1 = range[tid + 1];
            int32_t *touched;
            int64_t tag0;
            spa_cell *spa = arena_get(m, r1 - r0, &touched, &tag0);
            int64_t cap = 1024;
            for (int64_t i = r0; i < r1; i++) {
                int64_t w = Bp[i + 1] - Bp[i];
                for (int64_t t = Cp[i]; t < Cp[i + 1]; t++)
                    w += Up[Cj[t] + 1] - Up[Cj[t]];
                cap += w;
            }
            int32_t *oj = (int32_t *)malloc(sizeof(int32_t) * (size_t)cap);
            int64_t *ox = (int64_t *)malloc(sizeof(int64_t) * (size_t)cap);
            if (!spa || !oj || !ox) {
#pragma omp atomic write
                fail = 1;
            } else {
                int64_t nout = 0;
                for (int64_t i = r0; i < r1; i++) {
                    const int64_t tag = tag0 + (i - r0);
                    int64_t ntouch = 0;
                    for (int64_t t = Bp[i]; t < Bp[i + 1]; t++) {
                        int32_t j = Bj[t];
                        if (spa[j].stamp != tag) {
                            spa[j].stamp = tag; spa[j].val = 0;
                            touched[ntouch++] = j;
                        }
                        spa[j].val += Bx[t];
                    }
                    for (int64_t t = Cp[i]; t < Cp[i + 1]; t++) {
                        int32_t k = Cj[t];
                        int64_t c = Cx[t];
                        if (reduce_each) {
                            for (int64_t u = Up[k]; u < Up[k + 1]; u++) {
                                int32_t j = Uj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val = balanced(
                                    spa[j].val - c * Ux[u], P, halfp);
                            }
                        } else {
                            for (int64_t u = Up[k]; u < Up[k + 1]; u++) {
                                int32_t j = Uj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val -= c * Ux[u];
                            }
                        }
                    }
                    /* deterministic output: sort touched column list */
                    if (ntouch > 1)
                        sort_touched(touched, ntouch);
                    int64_t row_start = nout;
                    for (int64_t t = 0; t < ntouch; t++) {
                        int32_t j = touched[t];
                        int64_t v = balanced(spa[j].val, P, halfp);
                        if (v) { oj[nout] = j; ox[nout] = v; nout++; }
                    }
                    outp[i + 1] = nout - row_start; /* counts; prefixed later */
                }
                tj[tid] = oj; tx[tid] = ox; tn[tid] = nout;
                oj = NULL; ox = NULL;
            }
            if (oj) free(oj);
            if (ox) free(ox);
        }
    }
    if (fail) {
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    /* stitch: prefix the per-row counts into indptr, then copy thread
       buffers into one output in row order */
    outp[0] = 0;
    for (int64_t i = 0; i < q; i++) outp[i + 1] += outp[i];
    int64_t total = outp[q];
    int32_t *all_j = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
    int64_t *all_x = (int64_t *)malloc(sizeof(int64_t) * (size_t)(total ? total : 1));
    if (!all_j || !all_x) {
        free(all_j); free(all_x);
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    for (int t = 0; t < nthreads; t++) {
        int64_t dst = outp[range[t]];
        if (tn[t]) {
            memcpy(all_j + dst, tj[t], sizeof(int32_t) * (size_t)tn[t]);
            memcpy(all_x + dst, tx[t], sizeof(int64_t) * (size_t)tn[t]);
        }
        free(tj[t]); free(tx[t]);
    }
    free(tj); free(tx); free(tn); free(range);
    *out_j_ret = all_j;
    *out_x_ret = all_x;
    return total;
}

int spasm_tpu_cmp_i32(const void *a, const void *b)
{
    int32_t x = *(const int32_t *)a, y = *(const int32_t *)b;
    return (x > y) - (x < y);
}

/* Ranged self-referential variant for the mutual-reduce backward sweep
 * (elimination.py mutual_reduce): D = B[0:q] - coeffs @ B[klo:khi] where
 * the coefficient of B row i against pivot row k (klo <= k < khi) is read
 * DIRECTLY off B[i, pivcol(k)] via qinv (qinv[j] = global pivot-row index
 * of column j, or -1).  B and U are the same CSR triple, so the caller
 * never materializes the prefix slice or the coefficient submatrix —
 * those two copies dominated the sweep at 50M-nnz scale.
 *
 * Note the pivot-column entries of D vanish exactly (U[k, pivcol(k)] == 1
 * cancels the coefficient), matching D = B - B[:, pc] @ U.
 */
int64_t spasm_tpu_schur_update_ranged(
    int64_t q, int64_t m, int64_t P, int64_t reduce_each,
    const int64_t *Bp, const int32_t *Bj, const int64_t *Bx,
    const int64_t *qinv, int64_t klo, int64_t khi,
    int64_t *outp, int32_t **out_j_ret, int64_t **out_x_ret)
{
    const int64_t halfp = P / 2;
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > q) nthreads = q > 0 ? (int)q : 1;
    if (nthreads < 1) nthreads = 1;
#endif
    /* contiguous row ranges balanced by input work */
    int64_t *work = (int64_t *)malloc(sizeof(int64_t) * (size_t)(q + 1));
    if (!work) return -1;
    work[0] = 0;
    for (int64_t i = 0; i < q; i++) {
        int64_t w = Bp[i + 1] - Bp[i];
        for (int64_t t = Bp[i]; t < Bp[i + 1]; t++) {
            int64_t k = qinv[Bj[t]];
            if (k >= klo && k < khi)
                w += Bp[k + 1] - Bp[k];
        }
        work[i + 1] = work[i] + w + 1;
    }
    int64_t total_work = work[q];
    int64_t *range = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nthreads + 1));
    if (!range) { free(work); return -1; }
    range[0] = 0;
    for (int t = 1; t < nthreads; t++) {
        int64_t target = total_work * t / nthreads;
        int64_t lo = range[t - 1], hi = q;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (work[mid] < target) lo = mid + 1; else hi = mid;
        }
        range[t] = lo;
    }
    range[nthreads] = q;
    free(work);

    int32_t **tj = (int32_t **)calloc((size_t)nthreads, sizeof(int32_t *));
    int64_t **tx = (int64_t **)calloc((size_t)nthreads, sizeof(int64_t *));
    int64_t *tn = (int64_t *)calloc((size_t)nthreads, sizeof(int64_t));
    int fail = 0;
    if (!tj || !tx || !tn) fail = 1;

    /* chunk loop, not tid-indexed regions: `omp for` executes every
     * chunk no matter how many threads the runtime actually delivers
     * (OMP_DYNAMIC / thread limits can hand out fewer than requested) */
#pragma omp parallel for schedule(dynamic) num_threads(nthreads)
    for (int tid = 0; tid < nthreads; tid++) {
        if (!flag_read(&fail)) {
            int64_t r0 = range[tid], r1 = range[tid + 1];
            int32_t *touched;
            int64_t tag0;
            spa_cell *spa = arena_get(m, r1 - r0, &touched, &tag0);
            int64_t cap = 1024;
            for (int64_t i = r0; i < r1; i++) {
                int64_t w = Bp[i + 1] - Bp[i];
                for (int64_t t = Bp[i]; t < Bp[i + 1]; t++) {
                    int64_t k = qinv[Bj[t]];
                    if (k >= klo && k < khi)
                        w += Bp[k + 1] - Bp[k];
                }
                cap += w;
            }
            int32_t *oj = (int32_t *)malloc(sizeof(int32_t) * (size_t)cap);
            int64_t *ox = (int64_t *)malloc(sizeof(int64_t) * (size_t)cap);
            if (!spa || !oj || !ox) {
#pragma omp atomic write
                fail = 1;
            } else {
                int64_t nout = 0;
                for (int64_t i = r0; i < r1; i++) {
                    const int64_t tag = tag0 + (i - r0);
                    int64_t ntouch = 0;
                    for (int64_t t = Bp[i]; t < Bp[i + 1]; t++) {
                        int32_t j = Bj[t];
                        if (spa[j].stamp != tag) {
                            spa[j].stamp = tag; spa[j].val = 0;
                            touched[ntouch++] = j;
                        }
                        spa[j].val += Bx[t];
                    }
                    for (int64_t t = Bp[i]; t < Bp[i + 1]; t++) {
                        int64_t k = qinv[Bj[t]];
                        if (k < klo || k >= khi)
                            continue;
                        int64_t c = Bx[t];
                        if (reduce_each) {
                            for (int64_t u = Bp[k]; u < Bp[k + 1]; u++) {
                                int32_t j = Bj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val = balanced(
                                    spa[j].val - c * Bx[u], P, halfp);
                            }
                        } else {
                            for (int64_t u = Bp[k]; u < Bp[k + 1]; u++) {
                                int32_t j = Bj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val -= c * Bx[u];
                            }
                        }
                    }
                    if (ntouch > 1)
                        sort_touched(touched, ntouch);
                    int64_t row_start = nout;
                    for (int64_t t = 0; t < ntouch; t++) {
                        int32_t j = touched[t];
                        int64_t v = balanced(spa[j].val, P, halfp);
                        if (v) { oj[nout] = j; ox[nout] = v; nout++; }
                    }
                    outp[i + 1] = nout - row_start;
                }
                tj[tid] = oj; tx[tid] = ox; tn[tid] = nout;
                oj = NULL; ox = NULL;
            }
            if (oj) free(oj);
            if (ox) free(ox);
        }
    }
    if (fail) {
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    outp[0] = 0;
    for (int64_t i = 0; i < q; i++) outp[i + 1] += outp[i];
    int64_t total = outp[q];
    int32_t *all_j = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
    int64_t *all_x = (int64_t *)malloc(sizeof(int64_t) * (size_t)(total ? total : 1));
    if (!all_j || !all_x) {
        free(all_j); free(all_x);
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    for (int t = 0; t < nthreads; t++) {
        int64_t dst = outp[range[t]];
        if (tn[t]) {
            memcpy(all_j + dst, tj[t], sizeof(int32_t) * (size_t)tn[t]);
            memcpy(all_x + dst, tx[t], sizeof(int64_t) * (size_t)tn[t]);
        }
        free(tj[t]); free(tx[t]);
    }
    free(tj); free(tx); free(tn); free(range);
    *out_j_ret = all_j;
    *out_x_ret = all_x;
    return total;
}

/* qinv-driven variant against a SEPARATE (mutually reduced) pivot block:
 * D = B - B[:, piv_cols] @ U where the coefficient of B row i against U
 * row k is read DIRECTLY off B[i, pivcol(k)] via qinv (qinv[j] = U row
 * index owning column j, or -1) — the caller never materializes the
 * (q x r) coefficient submatrix (a full O(nnz) column gather at tens of
 * M nnz).  U has unit pivots, so pivot-column entries of D vanish
 * exactly, matching the materialized product (elimination.py
 * eliminate_against_reduced). */
/* rowsel (optional, NULL = identity): output row i reads input row
 * rowsel[i] — the caller never materializes the row-subset gather of B
 * (the round loop's S_rest at tens of M nnz). */
int64_t spasm_tpu_schur_update_qinv(
    int64_t q, int64_t m, int64_t P, int64_t reduce_each,
    const int64_t *Bp, const int32_t *Bj, const int64_t *Bx,
    const int64_t *qinv, const int64_t *rowsel,
    const int64_t *Up, const int32_t *Uj, const int64_t *Ux,
    int64_t *outp, int32_t **out_j_ret, int64_t **out_x_ret)
{
#define QV_ROW(i) (rowsel ? rowsel[(i)] : (i))
    const int64_t halfp = P / 2;
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
    if (nthreads > 16) nthreads = 16;
    if ((int64_t)nthreads > q) nthreads = q > 0 ? (int)q : 1;
    if (nthreads < 1) nthreads = 1;
#endif
    int64_t *work = (int64_t *)malloc(sizeof(int64_t) * (size_t)(q + 1));
    if (!work) return -1;
    work[0] = 0;
    for (int64_t i = 0; i < q; i++) {
        const int64_t o = QV_ROW(i);
        int64_t w = Bp[o + 1] - Bp[o];
        for (int64_t t = Bp[o]; t < Bp[o + 1]; t++) {
            int64_t k = qinv[Bj[t]];
            if (k >= 0)
                w += Up[k + 1] - Up[k];
        }
        work[i + 1] = work[i] + w + 1;
    }
    int64_t total_work = work[q];
    int64_t *range = (int64_t *)malloc(sizeof(int64_t) * (size_t)(nthreads + 1));
    if (!range) { free(work); return -1; }
    range[0] = 0;
    for (int t = 1; t < nthreads; t++) {
        int64_t target = total_work * t / nthreads;
        int64_t lo = range[t - 1], hi = q;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (work[mid] < target) lo = mid + 1; else hi = mid;
        }
        range[t] = lo;
    }
    range[nthreads] = q;
    free(work);

    int32_t **tj = (int32_t **)calloc((size_t)nthreads, sizeof(int32_t *));
    int64_t **tx = (int64_t **)calloc((size_t)nthreads, sizeof(int64_t *));
    int64_t *tn = (int64_t *)calloc((size_t)nthreads, sizeof(int64_t));
    int fail = 0;
    if (!tj || !tx || !tn) fail = 1;

    /* chunk loop, not tid-indexed regions: `omp for` executes every
     * chunk no matter how many threads the runtime actually delivers
     * (OMP_DYNAMIC / thread limits can hand out fewer than requested) */
#pragma omp parallel for schedule(dynamic) num_threads(nthreads)
    for (int tid = 0; tid < nthreads; tid++) {
        if (!flag_read(&fail)) {
            int64_t r0 = range[tid], r1 = range[tid + 1];
            int32_t *touched;
            int64_t tag0;
            spa_cell *spa = arena_get(m, r1 - r0, &touched, &tag0);
            int64_t cap = 1024;
            for (int64_t i = r0; i < r1; i++) {
                const int64_t o = QV_ROW(i);
                int64_t w = Bp[o + 1] - Bp[o];
                for (int64_t t = Bp[o]; t < Bp[o + 1]; t++) {
                    int64_t k = qinv[Bj[t]];
                    if (k >= 0)
                        w += Up[k + 1] - Up[k];
                }
                cap += w;
            }
            int32_t *oj = (int32_t *)malloc(sizeof(int32_t) * (size_t)cap);
            int64_t *ox = (int64_t *)malloc(sizeof(int64_t) * (size_t)cap);
            if (!spa || !oj || !ox) {
#pragma omp atomic write
                fail = 1;
            } else {
                int64_t nout = 0;
                for (int64_t i = r0; i < r1; i++) {
                    const int64_t o = QV_ROW(i);
                    const int64_t tag = tag0 + (i - r0);
                    int64_t ntouch = 0;
                    for (int64_t t = Bp[o]; t < Bp[o + 1]; t++) {
                        int32_t j = Bj[t];
                        if (spa[j].stamp != tag) {
                            spa[j].stamp = tag; spa[j].val = 0;
                            touched[ntouch++] = j;
                        }
                        spa[j].val += Bx[t];
                    }
                    for (int64_t t = Bp[o]; t < Bp[o + 1]; t++) {
                        int64_t k = qinv[Bj[t]];
                        if (k < 0)
                            continue;
                        if (t + 1 < Bp[o + 1]) {
                            /* hide the dependent random access to the next
                             * hit's pivot-row start behind this hit's axpy */
                            int64_t kn = qinv[Bj[t + 1]];
                            if (kn >= 0) {
                                __builtin_prefetch(&Uj[Up[kn]], 0, 1);
                                __builtin_prefetch(&Ux[Up[kn]], 0, 1);
                            }
                        }
                        int64_t c = Bx[t];
                        if (reduce_each) {
                            for (int64_t u = Up[k]; u < Up[k + 1]; u++) {
                                int32_t j = Uj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val = balanced(
                                    spa[j].val - c * Ux[u], P, halfp);
                            }
                        } else {
                            for (int64_t u = Up[k]; u < Up[k + 1]; u++)
                                __builtin_prefetch(&spa[Uj[u]], 1, 1);
                            for (int64_t u = Up[k]; u < Up[k + 1]; u++) {
                                int32_t j = Uj[u];
                                if (spa[j].stamp != tag) {
                                    spa[j].stamp = tag; spa[j].val = 0;
                                    touched[ntouch++] = j;
                                }
                                spa[j].val -= c * Ux[u];
                            }
                        }
                    }
                    if (ntouch > 1)
                        sort_touched(touched, ntouch);
                    int64_t row_start = nout;
                    for (int64_t t = 0; t < ntouch; t++) {
                        int32_t j = touched[t];
                        int64_t v = balanced(spa[j].val, P, halfp);
                        if (v) { oj[nout] = j; ox[nout] = v; nout++; }
                    }
                    outp[i + 1] = nout - row_start;
                }
                tj[tid] = oj; tx[tid] = ox; tn[tid] = nout;
                oj = NULL; ox = NULL;
            }
            if (oj) free(oj);
            if (ox) free(ox);
        }
    }
    if (fail) {
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    outp[0] = 0;
    for (int64_t i = 0; i < q; i++) outp[i + 1] += outp[i];
    int64_t total = outp[q];
    int32_t *all_j = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total ? total : 1));
    int64_t *all_x = (int64_t *)malloc(sizeof(int64_t) * (size_t)(total ? total : 1));
    if (!all_j || !all_x) {
        free(all_j); free(all_x);
        for (int t = 0; t < nthreads; t++) { free(tj[t]); free(tx[t]); }
        free(tj); free(tx); free(tn); free(range);
        return -1;
    }
    for (int t = 0; t < nthreads; t++) {
        int64_t dst = outp[range[t]];
        if (tn[t]) {
            memcpy(all_j + dst, tj[t], sizeof(int32_t) * (size_t)tn[t]);
            memcpy(all_x + dst, tx[t], sizeof(int64_t) * (size_t)tn[t]);
        }
        free(tj[t]); free(tx[t]);
    }
    free(tj); free(tx); free(tn); free(range);
    *out_j_ret = all_j;
    *out_x_ret = all_x;
    return total;
}
