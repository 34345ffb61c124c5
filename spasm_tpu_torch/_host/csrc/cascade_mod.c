/* Per-row cascade elimination against a FIXED ordered pivot block over
 * GF(p) — one core, two entry points:
 *
 *   spasm_tpu_cascade_nnz        count surviving nnz (the Monte-Carlo
 *                                Schur density estimator's engine,
 *                                echelonize.py schur_estimate_density;
 *                                reference role:
 *                                spasm_schur_estimate_density,
 *                                src/SpaSM.jl:763)
 *   spasm_tpu_cascade_eliminate  emit residual rows + elimination
 *                                coefficients (the few-row route inside
 *                                elimination.py wave_eliminate:
 *                                triangular solves of single vectors,
 *                                certificate transcripts)
 *
 * U has unit pivots at pcol[k] and satisfies the append invariant (row k
 * touches only its own and LATER pivots' columns), so hits are processed
 * in increasing slot order via a binary min-heap worklist (the gplu_mod.c
 * scheme against a fixed basis): subtracting pivot row k can only
 * introduce hits at later slots.  Elimination against a triangular basis
 * is unique, so both counts and outputs match the level-wave path.
 *
 * Exactness: |x| kept below 2^61 by lazy balanced reduction; each axpy
 * adds |c*v| <= (p/2)^2 < 2^62 for every legal p <= 2^32 - 5, so the
 * accumulator stays within int64 between reductions.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int64_t casc_balanced(int64_t x, int64_t P, int64_t halfp)
{
    int64_t r = x % P;
    if (r > halfp)
        r -= P;
    else if (r < halfp - P + 1)
        r += P;
    return r;
}

void spasm_tpu_casc_free(void *p) { free(p); }

static int casc_grow_i32(int32_t **buf, int64_t *cap, int64_t need)
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

static int casc_grow_i64(int64_t **buf, int64_t *cap, int64_t need)
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

static int casc_cmp_i32(const void *a, const void *b)
{
    int32_t x = *(const int32_t *) a, y = *(const int32_t *) b;
    return (x > y) - (x < y);
}

/* emit == 0: return the total surviving nnz only (res_p/coef_p and the
 * buffer returns are ignored, may be NULL).  emit == 1: additionally
 * emit, per row, the residual entries (sorted columns, balanced values,
 * zeros at every pivot column) and the elimination coefficients (pivot
 * slot, balanced value; ascending slot order — the heap pops each slot
 * at most once).  B = coeffs @ U + residual exactly.  Returns total
 * residual nnz, or -1 on allocation failure.  Emitted buffers are
 * malloc'd here; the caller frees each via spasm_tpu_casc_free. */
static int64_t cascade_core(
    int emit,
    int64_t ns, int64_t m, int64_t r, int64_t P,
    const int64_t *Sp, const int32_t *Sj, const int64_t *Sx,
    const int64_t *Up, const int32_t *Uj, const int64_t *Ux,
    const int64_t *qinv, const int64_t *pcol,
    int64_t *res_p, int32_t **res_j_ret, int64_t **res_x_ret,
    int64_t *coef_p, int64_t **coef_k_ret, int64_t **coef_c_ret)
{
    const int64_t halfp = P / 2;
    const int64_t LIM = (int64_t) 1 << 61;
    int64_t *x = (int64_t *) malloc(sizeof(int64_t) * (size_t) m);
    int64_t *stamp = (int64_t *) malloc(sizeof(int64_t) * (size_t) m);
    int32_t *touched = (int32_t *) malloc(sizeof(int32_t) * (size_t) m);
    int64_t *heap = (int64_t *) malloc(sizeof(int64_t) * (size_t) (r + 1));
    uint8_t *inq = (uint8_t *) calloc((size_t) (r > 0 ? r : 1), 1);
    int32_t *rj = NULL;
    int64_t *rx = NULL, *ck = NULL, *cc = NULL;
    int64_t rcap = 0, rcap2 = 0, ccap = 0, ccap2 = 0;
    int64_t nres = 0, ncoef = 0, total = 0;
    if (!x || !stamp || !touched || !heap || !inq)
        goto fail;
    memset(stamp, 0xff, sizeof(int64_t) * (size_t) m);
    if (emit) {
        res_p[0] = 0;
        coef_p[0] = 0;
    }
    for (int64_t i = 0; i < ns; i++) {
        int64_t ntouch = 0, nheap = 0;
        for (int64_t t = Sp[i]; t < Sp[i + 1]; t++) {
            int32_t j = Sj[t];
            if (stamp[j] != i) {
                stamp[j] = i; x[j] = 0;
                touched[ntouch++] = j;
            }
            x[j] += Sx[t];
            int64_t k = qinv[j];
            if (k >= 0 && !inq[k]) {
                inq[k] = 1;
                /* sift up */
                int64_t c = nheap++;
                heap[c] = k;
                while (c > 0) {
                    int64_t par = (c - 1) / 2;
                    if (heap[par] <= heap[c]) break;
                    int64_t tmp = heap[par]; heap[par] = heap[c];
                    heap[c] = tmp;
                    c = par;
                }
            }
        }
        while (nheap > 0) {
            int64_t k = heap[0];
            inq[k] = 0;
            /* pop: move last to root, sift down */
            heap[0] = heap[--nheap];
            int64_t c = 0;
            for (;;) {
                int64_t l = 2 * c + 1, rr = l + 1, s = c;
                if (l < nheap && heap[l] < heap[s]) s = l;
                if (rr < nheap && heap[rr] < heap[s]) s = rr;
                if (s == c) break;
                int64_t tmp = heap[s]; heap[s] = heap[c]; heap[c] = tmp;
                c = s;
            }
            int32_t jk = (int32_t) pcol[k];
            if (stamp[jk] != i)
                continue;
            int64_t cval = casc_balanced(x[jk], P, halfp);
            if (cval == 0) {
                x[jk] = 0;
                continue;
            }
            if (emit) {
                if (casc_grow_i64(&ck, &ccap, ncoef + 1) < 0
                    || casc_grow_i64(&cc, &ccap2, ncoef + 1) < 0)
                    goto fail;
                ck[ncoef] = k;
                cc[ncoef] = cval;
                ncoef++;
            }
            for (int64_t u = Up[k]; u < Up[k + 1]; u++) {
                int32_t j = Uj[u];
                if (stamp[j] != i) {
                    stamp[j] = i; x[j] = 0;
                    touched[ntouch++] = j;
                }
                x[j] -= cval * Ux[u];
                if (x[j] > LIM || x[j] < -LIM)
                    x[j] = casc_balanced(x[j], P, halfp);
                int64_t k2 = qinv[j];
                if (k2 > k && !inq[k2]) {
                    inq[k2] = 1;
                    int64_t c2 = nheap++;
                    heap[c2] = k2;
                    while (c2 > 0) {
                        int64_t par = (c2 - 1) / 2;
                        if (heap[par] <= heap[c2]) break;
                        int64_t tmp = heap[par]; heap[par] = heap[c2];
                        heap[c2] = tmp;
                        c2 = par;
                    }
                }
            }
            /* unit pivot cancels the coefficient exactly */
            x[jk] = casc_balanced(x[jk], P, halfp);
        }
        if (emit && ntouch > 1)
            qsort(touched, (size_t) ntouch, sizeof(int32_t), casc_cmp_i32);
        for (int64_t t = 0; t < ntouch; t++) {
            int32_t j = touched[t];
            int64_t v = casc_balanced(x[j], P, halfp);
            if (!v)
                continue;
            total++;
            if (emit) {
                if (casc_grow_i32(&rj, &rcap, nres + 1) < 0
                    || casc_grow_i64(&rx, &rcap2, nres + 1) < 0)
                    goto fail;
                rj[nres] = j;
                rx[nres] = v;
                nres++;
            }
        }
        if (emit) {
            res_p[i + 1] = nres;
            coef_p[i + 1] = ncoef;
        }
    }
    free(x); free(stamp); free(touched); free(heap); free(inq);
    if (emit) {
        if (!rj) rj = (int32_t *) malloc(sizeof(int32_t));
        if (!rx) rx = (int64_t *) malloc(sizeof(int64_t));
        if (!ck) ck = (int64_t *) malloc(sizeof(int64_t));
        if (!cc) cc = (int64_t *) malloc(sizeof(int64_t));
        if (!rj || !rx || !ck || !cc) {
            free(rj); free(rx); free(ck); free(cc);
            return -1;
        }
        *res_j_ret = rj; *res_x_ret = rx;
        *coef_k_ret = ck; *coef_c_ret = cc;
    }
    return total;
fail:
    free(x); free(stamp); free(touched); free(heap); free(inq);
    free(rj); free(rx); free(ck); free(cc);
    return -1;
}

int64_t spasm_tpu_cascade_nnz(
    int64_t ns, int64_t m, int64_t r, int64_t P,
    const int64_t *Sp, const int32_t *Sj, const int64_t *Sx,
    const int64_t *Up, const int32_t *Uj, const int64_t *Ux,
    const int64_t *qinv, const int64_t *pcol)
{
    return cascade_core(0, ns, m, r, P, Sp, Sj, Sx, Up, Uj, Ux,
                        qinv, pcol, NULL, NULL, NULL, NULL, NULL, NULL);
}

int64_t spasm_tpu_cascade_eliminate(
    int64_t ns, int64_t m, int64_t r, int64_t P,
    const int64_t *Sp, const int32_t *Sj, const int64_t *Sx,
    const int64_t *Up, const int32_t *Uj, const int64_t *Ux,
    const int64_t *qinv, const int64_t *pcol,
    int64_t *res_p, int32_t **res_j_ret, int64_t **res_x_ret,
    int64_t *coef_p, int64_t **coef_k_ret, int64_t **coef_c_ret)
{
    return cascade_core(1, ns, m, r, P, Sp, Sj, Sx, Up, Uj, Ux,
                        qinv, pcol, res_p, res_j_ret, res_x_ret,
                        coef_p, coef_k_ret, coef_c_ret);
}
