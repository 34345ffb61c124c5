/* OpenMP scatter-reduction kernels for the structural pivot search.
 *
 * Host analog of the reference's OpenMP-parallel pivot extraction
 * (spasm_pivots_extract_structural, src/SpaSM.jl:775-778): the pivot
 * strategies reduce to a handful of scatter-min / scatter-max /
 * scatter-add passes over the entry set, and NumPy's ufunc.at runs them
 * at ~20 M entries/s (unbuffered inner loop).  These kernels are plain
 * memory-bound loops; with per-thread private accumulators they run at
 * memory speed and stay deterministic.
 *
 * All kernels take int64 index arrays (bounds are the caller's problem)
 * and update `tgt` in place, exactly like np.minimum.at / np.maximum.at /
 * np.add.at.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads(void) { return 1; }
static int omp_get_thread_num(void) { return 0; }
#endif

/* Below this entry count the OpenMP setup + private-copy reduction costs
 * more than the serial loop. */
#define SERIAL_CUTOFF (1 << 16)

#define DEFINE_SCATTER(NAME, T, OP)                                     \
void NAME(T *tgt, int64_t ntgt, const int64_t *idx, const T *val,       \
          int64_t n, T init)                                            \
{                                                                       \
    if (n < SERIAL_CUTOFF) {                                            \
        for (int64_t k = 0; k < n; k++) {                               \
            T *t = &tgt[idx[k]];                                        \
            *t = OP(*t, val[k]);                                        \
        }                                                               \
        return;                                                         \
    }                                                                   \
    int nt = omp_get_max_threads();                                     \
    T *priv = (T *) malloc((size_t) nt * (size_t) ntgt * sizeof(T));    \
    if (!priv) { /* fall back to serial */                              \
        for (int64_t k = 0; k < n; k++) {                               \
            T *t = &tgt[idx[k]];                                        \
            *t = OP(*t, val[k]);                                        \
        }                                                               \
        return;                                                         \
    }                                                                   \
    _Pragma("omp parallel")                                             \
    {                                                                   \
        int tid = omp_get_thread_num();                                 \
        T *mine = priv + (size_t) tid * (size_t) ntgt;                  \
        for (int64_t j = 0; j < ntgt; j++)                              \
            mine[j] = init;                                             \
        _Pragma("omp for schedule(static)")                             \
        for (int64_t k = 0; k < n; k++) {                               \
            T *t = &mine[idx[k]];                                       \
            *t = OP(*t, val[k]);                                        \
        }                                                               \
        _Pragma("omp for schedule(static)")                             \
        for (int64_t j = 0; j < ntgt; j++) {                            \
            T acc = tgt[j];                                             \
            for (int t = 0; t < nt; t++) {                              \
                T v = priv[(size_t) t * (size_t) ntgt + j];             \
                acc = OP(acc, v);                                       \
            }                                                           \
            tgt[j] = acc;                                               \
        }                                                               \
    }                                                                   \
    free(priv);                                                         \
}

#define MIN_OP(a, b) ((a) < (b) ? (a) : (b))
#define MAX_OP(a, b) ((a) > (b) ? (a) : (b))
#define ADD_OP(a, b) ((a) + (b))

DEFINE_SCATTER(scatter_min_i64, int64_t, MIN_OP)
DEFINE_SCATTER(scatter_min_f64, double, MIN_OP)
DEFINE_SCATTER(scatter_max_i64, int64_t, MAX_OP)
DEFINE_SCATTER(scatter_max_f64, double, MAX_OP)
DEFINE_SCATTER(scatter_add_i64, int64_t, ADD_OP)

/* Longest-path levels over an elimination DAG whose edges (src -> dst)
 * satisfy src < dst and arrive sorted by src ascending (the natural
 * rows_expanded order of pivot_graph_edges).  Because every edge INTO a
 * node s has source < s, by the time the scan reaches edges with src == s
 * the value levels[s] is final — so one sequential pass replaces the
 * depth-many vectorized fixpoint iterations of the NumPy path.
 * levels must be zero-initialized by the caller. */
void levels_from_sorted_edges(const int64_t *src, const int64_t *dst,
                              int64_t ne, int64_t *levels)
{
    for (int64_t k = 0; k < ne; k++) {
        int64_t cand = levels[src[k]] + 1;
        if (cand > levels[dst[k]])
            levels[dst[k]] = cand;
    }
}
