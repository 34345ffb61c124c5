/* Dense (vector-RHS) permuted triangular solves over GF(p).
 *
 * Native port of spasm_tpu/solve.py dense_back_solve / dense_forward_solve
 * (the reference's spasm_dense_back_solve / spasm_dense_forward_solve,
 * src/SpaSM.jl:663-692).  These are inherently sequential column-by-column
 * (resp. row-by-row) substitutions — each step consumes updates from the
 * previous — so the win over the Python loop is constant-factor (~10^3 at
 * scale), not parallelism.
 *
 * Both return 0 on success, 1 if the system is unsolvable, writing the
 * solution into x.  b is clobbered.  Values are balanced ints in
 * [-p/2, p/2]; products fit int64 for p <= 2^32-5.
 */

#include <stdint.h>

static inline int64_t ts_balanced(int64_t v, int64_t P, int64_t halfp)
{
    int64_t r = v % P;
    if (r > halfp)
        r -= P;
    else if (r < halfp - P + 1)
        r += P;
    return r;
}

/* balanced modular inverse via extended Euclid (a must be invertible) */
static int64_t ts_inv(int64_t a, int64_t P)
{
    int64_t r0 = P, r1 = a % P;
    if (r1 < 0)
        r1 += P;
    int64_t t0 = 0, t1 = 1;
    while (r1 != 0) {
        int64_t q = r0 / r1;
        int64_t tmp = r0 - q * r1;
        r0 = r1;
        r1 = tmp;
        tmp = t0 - q * t1;
        t0 = t1;
        t1 = tmp;
    }
    int64_t inv = t0 % P;
    if (inv < 0)
        inv += P;
    if (inv > P / 2)
        inv -= P;
    return inv;
}

/* x @ L == b with L (n x m) permuted lower-triangular, diagonal of column
 * j at row p[j] (need not be the row's first entry).  Row indices sorted
 * (canonical CSR), so the diagonal is found by binary search. */
int spasm_tpu_dense_back_solve(int64_t n, int64_t m,
                               const int64_t *indptr, const int32_t *indices,
                               const int32_t *data, const int64_t *p,
                               int64_t *b, int64_t *x, int64_t P)
{
    int64_t halfp = P / 2;
    for (int64_t j = m - 1; j >= 0; j--) {
        if (b[j] == 0)
            continue;
        int64_t i = p[j];
        int64_t lo = indptr[i], hi = indptr[i + 1];
        /* binary search for column j in row i */
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (indices[mid] < (int32_t) j)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo >= indptr[i + 1] || indices[lo] != (int32_t) j)
            return 1;
        int64_t coef = ts_balanced(b[j] * ts_inv((int64_t) data[lo], P),
                                   P, halfp);
        x[i] = coef;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; k++)
            b[indices[k]] = ts_balanced(b[indices[k]]
                                        - coef * (int64_t) data[k],
                                        P, halfp);
    }
    for (int64_t j = 0; j < m; j++)
        if (b[j] != 0)
            return 1;
    return 0;
}

/* x @ U == b with U (n x m) permuted upper-triangular, UNIT pivot of row i
 * at column q[i] (reference semantics: the pivot value is trusted to be 1
 * and not re-checked, src/SpaSM.jl:679-692). */
int spasm_tpu_dense_forward_solve(int64_t n, int64_t m,
                                  const int64_t *indptr,
                                  const int32_t *indices,
                                  const int32_t *data, const int64_t *q,
                                  int64_t *b, int64_t *x, int64_t P)
{
    int64_t halfp = P / 2;
    (void) m;
    for (int64_t i = 0; i < n; i++) {
        int64_t j = q[i];
        if (b[j] == 0)
            continue;
        int64_t xi = b[j];
        x[i] = xi;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; k++)
            b[indices[k]] = ts_balanced(b[indices[k]]
                                        - xi * (int64_t) data[k],
                                        P, halfp);
    }
    for (int64_t j = 0; j < m; j++)
        if (b[j] != 0)
            return 1;
    return 0;
}
