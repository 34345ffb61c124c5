/* Parallel CSR row ops for the round loop's split/scale phase
 * (echelonize.py _round_schur_estimate): OpenMP row gather (the
 * scipy S[rows] fancy-index is single-threaded) and in-place row
 * scaling by per-row factors (avoids the 20M-entry np.repeat +
 * gathered multiply temporary).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

static inline int64_t ro_balanced(int64_t x, int64_t P, int64_t halfp)
{
    int64_t r = x % P;
    if (r > halfp)
        r -= P;
    else if (r < halfp - P + 1)
        r += P;
    return r;
}

/* Gather rows[0..nr) of (Sp,Sj,Sx) into a fresh CSR.  outp (nr+1) is the
 * PREFILLED output indptr (the caller already computed the row-length
 * prefix to size out_j/out_x — no second length pass here).  Returns
 * total nnz. */
int64_t spasm_tpu_gather_rows(
    int64_t nr, const int64_t *rows,
    const int64_t *Sp, const int32_t *Sj, const int64_t *Sx,
    const int64_t *outp, int32_t *out_j, int64_t *out_x)
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nr; i++) {
        int64_t k = rows[i];
        int64_t s0 = Sp[k];
        int64_t len = Sp[k + 1] - s0;
        int64_t d0 = outp[i];
        if (len <= 24) {
            /* typical sparse rows are ~10 entries: inline copies beat
             * two memcpy calls per row */
            for (int64_t t = 0; t < len; t++) {
                out_j[d0 + t] = Sj[s0 + t];
                out_x[d0 + t] = Sx[s0 + t];
            }
        } else {
            memcpy(out_j + d0, Sj + s0, sizeof(int32_t) * (size_t) len);
            memcpy(out_x + d0, Sx + s0, sizeof(int64_t) * (size_t) len);
        }
    }
    return outp[nr];
}

/* In-place x[row slice] *= scale[row] (mod p balanced when normalize,
 * raw product otherwise — the +-1 fast path multiplies balanced data by
 * +-1 which stays balanced). */
void spasm_tpu_scale_rows(
    int64_t nr, const int64_t *indptr, int64_t *data,
    const int64_t *scale, int64_t P, int64_t normalize)
{
    const int64_t halfp = P / 2;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < nr; i++) {
        int64_t s = scale[i];
        if (s == 1)
            continue;
        if (normalize) {
            for (int64_t t = indptr[i]; t < indptr[i + 1]; t++)
                data[t] = ro_balanced(data[t] * s, P, halfp);
        } else {
            for (int64_t t = indptr[i]; t < indptr[i + 1]; t++)
                data[t] *= s;
        }
    }
}

/* out[i] = balanced(x[i] mod P) in one OpenMP pass (field.Field.normalize's
 * numpy chain is mod + where + astype = three full passes + temporaries;
 * at 20M entries per L-recording round that is ~1 s of the certificate
 * flow). */
void spasm_tpu_normalize_i64(
    int64_t n, const int64_t *x, int64_t P, int64_t *out)
{
    const int64_t halfp = P / 2;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++)
        out[i] = ro_balanced(x[i], P, halfp);
}
