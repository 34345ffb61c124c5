/* Greedy cycle-free completion of the structural pivot search.
 *
 * The whole of pivots.greedy_pivots in one call: its batched passes and
 * its sequential mop-up (_greedy_sequential), straight off the CSR and
 * the four state arrays.  The NumPy formulation pays a pass of ufuncs
 * over the live entries per batched pass and a Python iteration per
 * mop-up row; here both are plain loops.
 *
 * The result is bit-identical to the NumPy formulation: the same pivots
 * in the same order, the same positions, the same state arrays.  Every
 * OpenMP loop of the batched pass is row-local or a min / max reduction
 * into a shared array (atomic compare-and-swap), so nothing depends on
 * the thread count.  The mop-up is serial, as its rule is.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

/* Below this many live entries a pass runs its loops on one thread. */
#define PAR_MIN_ENTRIES (1 << 16)

static inline void atomic_min_i64(int64_t *p, int64_t v)
{
    int64_t cur = __atomic_load_n(p, __ATOMIC_RELAXED);
    while (v < cur && !__atomic_compare_exchange_n(
               p, &cur, v, 1, __ATOMIC_RELAXED, __ATOMIC_RELAXED))
        ;
}

static inline void atomic_max_f64(double *p, double v)
{
    double cur;
    __atomic_load(p, &cur, __ATOMIC_RELAXED);
    while (v > cur && !__atomic_compare_exchange(
               p, &cur, &v, 1, __ATOMIC_RELAXED, __ATOMIC_RELAXED))
        ;
}

/* The insertion position strictly between p1 (the largest position of a
 * selected pivot whose row touches the column; -inf if none) and p2 (the
 * smallest position of a selected pivot column in the row; +inf if
 * none).  Returns 0 where the midpoint does not fall strictly inside,
 * which float underflow in a crowded gap can cause. */
static inline int insert_pos(double p1, double p2, double *q)
{
    double lo = isfinite(p1) ? p1 : (isfinite(p2) ? p2 - 2.0 : 0.0);
    double hi = isfinite(p2) ? p2 : lo + 2.0;
    *q = 0.5 * (lo + hi);
    return p1 < *q && *q < p2;
}

/* n x m CSR (indptr, int32 indices; n, m < 2^31).  State arrays as in
 * greedy_pivots, updated in place.  out_* hold min(n, m) pivots.
 * Returns the number of pivots written, or -1 (nothing changed) when the
 * scratch cannot be allocated. */
int64_t spasm_tpu_greedy_pivots(int64_t n, int64_t m,
                                const int64_t *indptr,
                                const int32_t *indices,
                                uint8_t *col_selected, uint8_t *row_used,
                                double *piv_pos_of_col,
                                double *col_touch_max, int64_t max_passes,
                                int64_t mopup, int64_t cap,
                                int64_t *out_rows, int64_t *out_cols,
                                double *out_pos)
{
    int64_t nnz = indptr[n];
    int64_t maxlen = 0;
    for (int64_t i = 0; i < n; i++)
        if (indptr[i + 1] - indptr[i] > maxlen)
            maxlen = indptr[i + 1] - indptr[i];
    int64_t *col_counts = (int64_t *) calloc((size_t) m + 1, 8);
    int64_t *live = (int64_t *) malloc(((size_t) n + 1) * 8);
    int64_t *bucket = (int64_t *) calloc((size_t) maxlen + 2, 8);
    int64_t *best = (int64_t *) malloc(((size_t) n + 1) * 8);
    double *p2_of = (double *) malloc(((size_t) n + 1) * 8);
    double *q_of = (double *) malloc(((size_t) n + 1) * 8);
    int64_t *mc = (int64_t *) malloc(((size_t) m + 1) * 8);
    if (!col_counts || !live || !bucket || !best || !p2_of || !q_of ||
        !mc) {
        free(col_counts), free(live), free(bucket), free(best);
        free(p2_of), free(q_of), free(mc);
        return -1;
    }
    for (int64_t k = 0; k < nnz; k++)
        col_counts[indices[k]]++;

    /* the live rows (unused, nonempty) by (length, row): a stable
     * counting sort by length over ascending rows.  The batched passes'
     * candidate priority and the mop-up's order are both this order. */
    for (int64_t i = 0; i < n; i++)
        if (!row_used[i] && indptr[i + 1] > indptr[i])
            bucket[indptr[i + 1] - indptr[i] + 1]++;
    for (int64_t l = 1; l <= maxlen + 1; l++)
        bucket[l] += bucket[l - 1];
    int64_t nl = bucket[maxlen + 1];
    for (int64_t i = 0; i < n; i++)
        if (!row_used[i] && indptr[i + 1] > indptr[i])
            live[bucket[indptr[i + 1] - indptr[i]]++] = i;

    int64_t npiv = 0;
    int exhausted = 0;
    int64_t passes = max_passes > 8 ? max_passes : 8;
    for (int64_t pass = 0; pass < passes; pass++) {
        if (nl == 0) {
            exhausted = 1;
            break;
        }
        int64_t live_nnz = 0;
        for (int64_t k = 0; k < nl; k++)
            live_nnz += indptr[live[k] + 1] - indptr[live[k]];
        int par = live_nnz >= PAR_MIN_ENTRIES;
        /* per live row: p2, and the best eligible column by
         * (col_count, col), or -1 */
        int64_t ncand = 0;
#pragma omp parallel for schedule(static) reduction(+:ncand) if (par)
        for (int64_t k = 0; k < nl; k++) {
            int64_t i = live[k], lo = indptr[i], hi = indptr[i + 1];
            double p2 = INFINITY;
            for (int64_t t = lo; t < hi; t++) {
                double q = piv_pos_of_col[indices[t]];
                if (q < p2)
                    p2 = q;
            }
            int64_t jb = -1;
            for (int64_t t = lo; t < hi; t++) {
                int64_t j = indices[t];
                if (col_selected[j] || !(col_touch_max[j] < p2))
                    continue;
                if (jb < 0 || col_counts[j] < col_counts[jb] ||
                    (col_counts[j] == col_counts[jb] && j < jb))
                    jb = j;
            }
            p2_of[k] = p2;
            best[k] = jb;
            ncand += jb >= 0;
        }
        if (ncand == 0) {
            /* the mop-up tests the same eligibility: it would find
             * nothing */
            exhausted = 1;
            break;
        }
        /* mc[c]: the smallest priority (live index) of a candidate row
         * touching column c */
#pragma omp parallel for schedule(static) if (par)
        for (int64_t j = 0; j < m; j++)
            mc[j] = INT64_MAX;
#pragma omp parallel for schedule(static) if (par)
        for (int64_t k = 0; k < nl; k++) {
            if (best[k] < 0)
                continue;
            int64_t i = live[k];
            for (int64_t t = indptr[i]; t < indptr[i + 1]; t++)
                atomic_min_i64(&mc[indices[t]], k);
        }
        /* accept a candidate no lighter candidate interacts with, at the
         * midpoint of its gap in the state at the start of the pass */
        int64_t nacc = 0;
#pragma omp parallel for schedule(static) reduction(+:nacc) if (par)
        for (int64_t k = 0; k < nl; k++) {
            q_of[k] = NAN;
            if (best[k] < 0)
                continue;
            int64_t i = live[k];
            int viol = 0;
            for (int64_t t = indptr[i]; t < indptr[i + 1] && !viol; t++)
                viol = mc[indices[t]] < k;
            double q;
            if (!viol && insert_pos(col_touch_max[best[k]], p2_of[k], &q)) {
                q_of[k] = q;
                nacc++;
            }
        }
        if (nacc == 0)
            break;
        /* the accepted rows in priority order; the others stay live */
        int64_t kept = 0;
        for (int64_t k = 0; k < nl; k++) {
            if (isnan(q_of[k])) {
                live[kept++] = live[k];
                continue;
            }
            int64_t i = live[k], j = best[k];
            col_selected[j] = 1;
            row_used[i] = 1;
            piv_pos_of_col[j] = q_of[k];
            out_rows[npiv] = i;
            out_cols[npiv] = j;
            out_pos[npiv] = q_of[k];
            npiv++;
        }
#pragma omp parallel for schedule(static) if (par)
        for (int64_t a = npiv - nacc; a < npiv; a++) {
            int64_t i = out_rows[a];
            for (int64_t t = indptr[i]; t < indptr[i + 1]; t++)
                atomic_max_f64(&col_touch_max[indices[t]], out_pos[a]);
        }
        nl = kept;
        /* diminishing returns: leave the rest to the mop-up */
        if (nacc < (ncand / 64 > 16 ? ncand / 64 : 16))
            break;
    }

    if (!exhausted && mopup) {
        /* serial, lightest first, in cap-sized batches while a batch
         * accepts at least cap / 64 rows */
        int64_t in_batch = 0;
        int64_t batch_end = cap < nl ? cap : nl;
        for (int64_t k = 0; k < nl; k++) {
            if (k == batch_end) {
                if (in_batch * 64 < cap)
                    break;
                in_batch = 0;
                batch_end = batch_end + cap < nl ? batch_end + cap : nl;
            }
            int64_t i = live[k], lo = indptr[i], hi = indptr[i + 1];
            double p2 = INFINITY;
            for (int64_t t = lo; t < hi; t++) {
                double q = piv_pos_of_col[indices[t]];
                if (q < p2)
                    p2 = q;
            }
            /* the first column of least count, in the row's order */
            int64_t jb = -1;
            for (int64_t t = lo; t < hi; t++) {
                int64_t j = indices[t];
                if (col_selected[j] || !(col_touch_max[j] < p2))
                    continue;
                if (jb < 0 || col_counts[j] < col_counts[jb])
                    jb = j;
            }
            double q;
            if (jb < 0 || !insert_pos(col_touch_max[jb], p2, &q))
                continue;
            col_selected[jb] = 1;
            row_used[i] = 1;
            piv_pos_of_col[jb] = q;
            for (int64_t t = lo; t < hi; t++)
                if (q > col_touch_max[indices[t]])
                    col_touch_max[indices[t]] = q;
            out_rows[npiv] = i;
            out_cols[npiv] = jb;
            out_pos[npiv] = q;
            npiv++;
            in_batch++;
        }
    }
    free(col_counts), free(live), free(bucket), free(best);
    free(p2_of), free(q_of), free(mc);
    return npiv;
}
