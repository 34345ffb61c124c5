/* Per-row left-looking sparse LU over GF(p) — the GPLU finish.
 *
 * Native port of spasm_tpu/echelonize.py:_gplu_sequential (the
 * reference's actual GPLU algorithm: spasm_sparse_triangular_solve
 * driven row by row, src/SpaSM.jl:694-722,815).  It engages on residues
 * where the batched structural rounds degrade to ~1 pivot/round (dense
 * or dense-cored tails: every pair of rows interacts, so no two pivots
 * are mutually insertable); there a 10k-row residue costs minutes of
 * Python heap loop but ~1 s here.
 *
 * Row i is eliminated against the pivots found so far in increasing
 * pivot-index order via a binary min-heap worklist (valid because pivot
 * row k only touches columns of pivots selected AFTER k — the append
 * invariant), accumulating into a stamped sparse accumulator with lazy
 * balanced reduction.  A nonzero residual contributes a new unit pivot
 * at its leftmost column.  Outputs are bit-identical to the Python
 * implementation (pivot choice, row values, L coefficients).
 *
 * Inherently sequential (each row depends on all pivots before it) —
 * single-threaded by design, like the reference's GPLU.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int64_t gplu_balanced(int64_t x, int64_t P, int64_t halfp)
{
    int64_t r = x % P;
    if (r > halfp)
        r -= P;
    else if (r < halfp - P + 1)
        r += P;
    return r;
}

/* balanced modular inverse via extended Euclid (a must be invertible) */
static int64_t gplu_inv(int64_t a, int64_t P)
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
    int64_t halfp = P / 2;
    if (inv > halfp)
        inv -= P;
    return inv;
}

static int grow_i64(int64_t **buf, int64_t *cap, int64_t need)
{
    if (need <= *cap)
        return 0;
    int64_t nc = *cap ? *cap : 1024;
    while (nc < need)
        nc *= 2;
    int64_t *nb = (int64_t *) realloc(*buf, sizeof(int64_t) * (size_t) nc);
    if (!nb)
        return -1;
    *buf = nb;
    *cap = nc;
    return 0;
}

static int grow_i32(int32_t **buf, int64_t *cap, int64_t need)
{
    if (need <= *cap)
        return 0;
    int64_t nc = *cap ? *cap : 1024;
    while (nc < need)
        nc *= 2;
    int32_t *nb = (int32_t *) realloc(*buf, sizeof(int32_t) * (size_t) nc);
    if (!nb)
        return -1;
    *buf = nb;
    *cap = nc;
    return 0;
}

static int gplu_cmp_i32(const void *a, const void *b)
{
    int32_t x = *(const int32_t *) a, y = *(const int32_t *) b;
    return (x > y) - (x < y);
}

/* Returns the number of pivots r (>= 0), or -1 on allocation failure.
 * All *_ret buffers are malloc'd here; the caller frees each with
 * spasm_tpu_gplu_free.  With record_l == 0 the L buffers stay NULL. */
int64_t spasm_tpu_gplu(
    int64_t n, int64_t m, int64_t P, int64_t record_l,
    const int64_t *Sp, const int32_t *Sj, const int64_t *Sx,
    int64_t **up_ret, int32_t **uj_ret, int64_t **ux_ret,
    int64_t **pcol_ret, int64_t **prow_ret,
    int64_t **li_ret, int64_t **lk_ret, int64_t **lv_ret,
    int64_t *lnnz_ret)
{
    const int64_t halfp = P / 2;
    const int64_t LIM = (int64_t) 1 << 61;  /* lazy-reduce threshold */
    int64_t rmax = n < m ? n : m;

    int64_t *x = (int64_t *) malloc(sizeof(int64_t) * (size_t) m);
    int64_t *stamp = (int64_t *) malloc(sizeof(int64_t) * (size_t) m);
    int32_t *touched = (int32_t *) malloc(sizeof(int32_t) * (size_t) m);
    int64_t *qinv = (int64_t *) malloc(sizeof(int64_t) * (size_t) m);
    int64_t *heap = (int64_t *) malloc(sizeof(int64_t) * (size_t) (rmax + 1));
    uint8_t *inq = (uint8_t *) calloc((size_t) (rmax + 1), 1);
    int64_t *up = (int64_t *) malloc(sizeof(int64_t) * (size_t) (rmax + 1));
    int64_t *pcol = (int64_t *) malloc(sizeof(int64_t) * (size_t) (rmax + 1));
    int64_t *prow = (int64_t *) malloc(sizeof(int64_t) * (size_t) (rmax + 1));
    int32_t *uj = NULL;
    int64_t *ux = NULL;
    int64_t uj_cap = 0, ux_cap = 0, unnz = 0;
    int64_t *li = NULL, *lk = NULL, *lv = NULL;
    int64_t l_cap_i = 0, l_cap_k = 0, l_cap_v = 0, lnnz = 0;
    int64_t r = 0;
    int fail = 0;

    if (!x || !stamp || !touched || !qinv || !heap || !inq || !up
        || !pcol || !prow)
        fail = 1;
    if (!fail) {
        memset(stamp, 0xff, sizeof(int64_t) * (size_t) m);
        for (int64_t j = 0; j < m; j++)
            qinv[j] = -1;
        up[0] = 0;
    }

    for (int64_t i = 0; i < n && !fail; i++) {
        int64_t lo = Sp[i], hi = Sp[i + 1];
        if (lo == hi)
            continue;
        int64_t nt = 0, nh = 0;
        for (int64_t t = lo; t < hi; t++) {
            int32_t j = Sj[t];
            if (stamp[j] != i) {
                stamp[j] = i;
                x[j] = 0;
                touched[nt++] = j;
            }
            x[j] += Sx[t];
            int64_t k = qinv[j];
            if (k >= 0 && !inq[k]) {
                inq[k] = 1;
                /* heap push */
                int64_t c = nh++;
                while (c > 0) {
                    int64_t par = (c - 1) / 2;
                    if (heap[par] <= k)
                        break;
                    heap[c] = heap[par];
                    c = par;
                }
                heap[c] = k;
            }
        }
        while (nh > 0) {
            int64_t k = heap[0];
            /* heap pop (inq[k] may be cleared: pushes only target
               indices > the current pop, so k never re-enters) */
            inq[k] = 0;
            int64_t last = heap[--nh];
            int64_t c0 = 0;
            for (;;) {
                int64_t l = 2 * c0 + 1;
                if (l >= nh)
                    break;
                if (l + 1 < nh && heap[l + 1] < heap[l])
                    l++;
                if (heap[l] >= last)
                    break;
                heap[c0] = heap[l];
                c0 = l;
            }
            if (nh > 0)
                heap[c0] = last;
            int64_t pc = pcol[k];
            int64_t c = gplu_balanced(x[pc], P, halfp);
            if (c == 0) {
                x[pc] = 0;
                continue;
            }
            x[pc] = c;  /* unit pivot cancels it exactly below */
            if (record_l) {
                if (grow_i64(&li, &l_cap_i, lnnz + 1)
                    || grow_i64(&lk, &l_cap_k, lnnz + 1)
                    || grow_i64(&lv, &l_cap_v, lnnz + 1)) {
                    fail = 1;
                    break;
                }
                li[lnnz] = i;
                lk[lnnz] = k;
                lv[lnnz] = c;
                lnnz++;
            }
            for (int64_t u = up[k]; u < up[k + 1]; u++) {
                int32_t j = uj[u];
                if (stamp[j] != i) {
                    stamp[j] = i;
                    x[j] = 0;
                    touched[nt++] = j;
                }
                x[j] -= c * ux[u];
                if (x[j] > LIM || x[j] < -LIM)
                    x[j] = gplu_balanced(x[j], P, halfp);
                int64_t k2 = qinv[j];
                if (k2 > k && !inq[k2]) {
                    inq[k2] = 1;
                    int64_t cc = nh++;
                    while (cc > 0) {
                        int64_t par = (cc - 1) / 2;
                        if (heap[par] <= k2)
                            break;
                        heap[cc] = heap[par];
                        cc = par;
                    }
                    heap[cc] = k2;
                }
            }
        }
        if (fail)
            break;
        if (nt > 1) {
            if (nt <= 512) {  /* nearly-sorted (concatenated sorted runs) — see schur_mod.c */
                for (int64_t a_ = 1; a_ < nt; a_++) {
                    int32_t v = touched[a_];
                    int64_t b_ = a_ - 1;
                    while (b_ >= 0 && touched[b_] > v) {
                        touched[b_ + 1] = touched[b_];
                        b_--;
                    }
                    touched[b_ + 1] = v;
                }
            } else {
                qsort(touched, (size_t) nt, sizeof(int32_t), gplu_cmp_i32);
            }
        }
        /* leftmost nonzero residual column becomes the new pivot */
        int64_t jpiv = -1, vpiv = 0;
        for (int64_t t = 0; t < nt; t++) {
            int64_t v = gplu_balanced(x[touched[t]], P, halfp);
            x[touched[t]] = v;
            if (v && jpiv < 0) {
                jpiv = touched[t];
                vpiv = v;
            }
        }
        if (jpiv < 0)
            continue;  /* row dependent: nothing to add */
        int64_t inv = gplu_inv(vpiv, P);
        int64_t row_n = 0;
        for (int64_t t = 0; t < nt; t++)
            if (x[touched[t]])
                row_n++;
        if (grow_i32(&uj, &uj_cap, unnz + row_n)
            || grow_i64(&ux, &ux_cap, unnz + row_n)) {
            fail = 1;
            break;
        }
        for (int64_t t = 0; t < nt; t++) {
            int64_t v = x[touched[t]];
            if (v) {
                uj[unnz] = touched[t];
                ux[unnz] = gplu_balanced(v * inv, P, halfp);
                unnz++;
            }
        }
        qinv[jpiv] = r;
        pcol[r] = jpiv;
        prow[r] = i;
        up[r + 1] = unnz;
        if (record_l) {
            if (grow_i64(&li, &l_cap_i, lnnz + 1)
                || grow_i64(&lk, &l_cap_k, lnnz + 1)
                || grow_i64(&lv, &l_cap_v, lnnz + 1)) {
                fail = 1;
                break;
            }
            li[lnnz] = i;
            lk[lnnz] = r;
            lv[lnnz] = vpiv;
            lnnz++;
        }
        r++;
    }

    free(x);
    free(stamp);
    free(touched);
    free(qinv);
    free(heap);
    free(inq);
    if (fail) {
        free(up);
        free(pcol);
        free(prow);
        free(uj);
        free(ux);
        free(li);
        free(lk);
        free(lv);
        return -1;
    }
    *up_ret = up;
    *uj_ret = uj ? uj : (int32_t *) malloc(1);
    *ux_ret = ux ? ux : (int64_t *) malloc(1);
    *pcol_ret = pcol;
    *prow_ret = prow;
    *li_ret = li;
    *lk_ret = lk;
    *lv_ret = lv;
    *lnnz_ret = lnnz;
    return r;
}

void spasm_tpu_gplu_free(void *p)
{
    free(p);
}
