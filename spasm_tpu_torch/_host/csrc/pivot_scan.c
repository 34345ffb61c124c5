/* Fused structural-pivot-search scan kernels.
 *
 * Host analog of the OpenMP loops inside the reference's pivot extraction
 * (spasm_pivots_extract_structural, src/SpaSM.jl:775-778).  After the
 * Faugere-Lachartre row pass, the remaining strategies (FL "on columns",
 * greedy cycle-free completion) each need a handful of O(nnz) passes over
 * the entry set: candidate-column minima, append-invariant hit counts,
 * pivot-touch maxima, insertability tests.  Done one NumPy ufunc at a
 * time those passes dominate the whole pivot search at tens of millions
 * of entries; fused here they are two memory-speed sweeps over the CSR.
 *
 * Both kernels are exact reductions (min / max / any) over disjoint or
 * order-independent data, so their outputs are bit-identical to the
 * NumPy formulation in spasm_tpu/pivots.py regardless of thread count.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads(void) { return 1; }
static int omp_get_thread_num(void) { return 0; }
#endif

/* Pass 1 — one sweep over all rows computing, simultaneously:
 *   min_row[j]        (unselected column j): topmost UNUSED row with an
 *                     entry at j, else n          (FL-cols candidates)
 *   hits[i]           (unused row i): 1 iff the row has an entry in an
 *                     already-selected column     (append-invariant check)
 *   col_touch_max[j]  max pos_of_row over USED rows touching column j
 *                     (greedy insertability state)
 * Caller initializes min_row to n, hits to 0, col_touch_max to -inf.
 * Requires n, m < 2^31 (int32 row/col indices). */
void spasm_tpu_pivot_scan(int64_t n, int64_t m,
                          const int64_t *indptr, const int32_t *indices,
                          const uint8_t *row_used,
                          const uint8_t *col_selected,
                          const double *pos_of_row,
                          int32_t *min_row, uint8_t *hits,
                          double *col_touch_max)
{
    int nt = omp_get_max_threads();
    int32_t *mr_priv =
        (int32_t *) malloc((size_t) nt * (size_t) m * sizeof(int32_t));
    double *tc_priv =
        (double *) malloc((size_t) nt * (size_t) m * sizeof(double));
    if (!mr_priv || !tc_priv) {  /* serial fallback, outputs in place */
        free(mr_priv);
        free(tc_priv);
        for (int64_t i = 0; i < n; i++) {
            int64_t lo = indptr[i], hi = indptr[i + 1];
            if (row_used[i]) {
                double q = pos_of_row[i];
                for (int64_t k = lo; k < hi; k++) {
                    int32_t j = indices[k];
                    if (q > col_touch_max[j])
                        col_touch_max[j] = q;
                }
            } else {
                uint8_t h = 0;
                for (int64_t k = lo; k < hi; k++) {
                    int32_t j = indices[k];
                    if (col_selected[j])
                        h = 1;
                    else if ((int32_t) i < min_row[j])
                        min_row[j] = (int32_t) i;
                }
                hits[i] = h;
            }
        }
        return;
    }
#pragma omp parallel
    {
        int tid = omp_get_thread_num();
        int32_t *mr = mr_priv + (size_t) tid * (size_t) m;
        double *tc = tc_priv + (size_t) tid * (size_t) m;
        for (int64_t j = 0; j < m; j++) {
            mr[j] = (int32_t) n;
            tc[j] = -INFINITY;
        }
#pragma omp for schedule(static)
        for (int64_t i = 0; i < n; i++) {
            int64_t lo = indptr[i], hi = indptr[i + 1];
            if (row_used[i]) {
                double q = pos_of_row[i];
                for (int64_t k = lo; k < hi; k++) {
                    int32_t j = indices[k];
                    if (q > tc[j])
                        tc[j] = q;
                }
            } else {
                uint8_t h = 0;
                for (int64_t k = lo; k < hi; k++) {
                    int32_t j = indices[k];
                    if (col_selected[j])
                        h = 1;
                    else if ((int32_t) i < mr[j])
                        mr[j] = (int32_t) i;
                }
                hits[i] = h;
            }
        }
#pragma omp for schedule(static)
        for (int64_t j = 0; j < m; j++) {
            int32_t a = min_row[j];
            double t = col_touch_max[j];
            for (int t2 = 0; t2 < nt; t2++) {
                int32_t v = mr_priv[(size_t) t2 * (size_t) m + j];
                if (v < a)
                    a = v;
                double w = tc_priv[(size_t) t2 * (size_t) m + j];
                if (w > t)
                    t = w;
            }
            min_row[j] = a;
            col_touch_max[j] = t;
        }
    }
    free(mr_priv);
    free(tc_priv);
}

/* Pass 2 — greedy first-pass eligibility, row-local and exact: a row is
 * eligible iff it is unused and has an entry (i, j) with column j
 * unselected and col_touch_max[j] < p2(i), where p2(i) is the min
 * piv_pos_of_col over the row's support (inf at unselected columns, so
 * the min ranges over selected columns exactly as the NumPy scatter-min).
 * Returns the eligible-row count; elig must be zero-initialized. */
int64_t spasm_tpu_greedy_scan(int64_t n, int64_t m,
                              const int64_t *indptr,
                              const int32_t *indices,
                              const uint8_t *row_used,
                              const uint8_t *col_selected,
                              const double *piv_pos_of_col,
                              const double *col_touch_max, uint8_t *elig)
{
    (void) m;
    int64_t count = 0;
#pragma omp parallel for schedule(static) reduction(+:count)
    for (int64_t i = 0; i < n; i++) {
        if (row_used[i])
            continue;
        int64_t lo = indptr[i], hi = indptr[i + 1];
        double p2 = INFINITY;
        for (int64_t k = lo; k < hi; k++) {
            double q = piv_pos_of_col[indices[k]];
            if (q < p2)
                p2 = q;
        }
        uint8_t e = 0;
        for (int64_t k = lo; k < hi; k++) {
            int32_t j = indices[k];
            if (!col_selected[j] && col_touch_max[j] < p2) {
                e = 1;
                break;
            }
        }
        if (e) {
            elig[i] = 1;
            count++;
        }
    }
    return count;
}

/* Longest-path levels straight off the pivot block's CSR: the elimination
 * DAG edge (k -> qinv[j]) for every entry (k, j) hitting a LATER pivot's
 * column is consumed inline — no edge materialization (rows_expanded +
 * qinv gather + masks cost several O(nnz) passes in NumPy).  Rows arrive
 * in elimination order (append invariant: edges only point forward), so
 * one ascending pass computes exact levels.  Returns 0, or -1 on an
 * order violation (caller raises, matching the NumPy path's check).
 * levels must be zero-initialized. */
int64_t spasm_tpu_levels_from_csr(int64_t r, const int64_t *indptr,
                                  const int32_t *indices,
                                  const int64_t *qinv, int64_t *levels)
{
    for (int64_t k = 0; k < r; k++) {
        int64_t lk = levels[k] + 1;
        const int64_t lo = indptr[k], hi = indptr[k + 1];
        for (int64_t t = lo; t < hi; t++) {
            int64_t d = qinv[indices[t]];
            if (d < 0 || d == k)
                continue;
            if (d < k)
                return -1;
            if (levels[d] < lk)
                levels[d] = lk;
        }
    }
    return 0;
}
