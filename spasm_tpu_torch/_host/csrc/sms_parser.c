/* Fast SMS triplet-format tokenizer.
 *
 * Native replacement for the reference's mmap + hand-rolled integer parser
 * (src/SpaSM.jl:1044-1086 "much faster than parse") and the role of
 * spasm_triplet_load in spasm_io.c.  Parses the whole buffer in one pass:
 *
 *   <n> <m> M\n  (the field marker token is skipped, like the reference)
 *   <i> <j> <v>\n ...
 *   0 0 0\n      (terminator; optional)
 *
 * Returns the number of (i, j, v) triples written, or -1 on malformed
 * input / capacity overflow.  header receives {n, m}.  Values may be any
 * 64-bit integers (mod reduction happens on the Python side).
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

static const char *skip_to_int(const char *p, const char *end, int *neg) {
    *neg = 0;
    while (p < end) {
        char c = *p;
        if (c >= '0' && c <= '9') return p;
        if (c == '-') {
            *neg = !*neg;
        } else if (c != ' ' && c != '\t' && c != '\n' && c != '\r' &&
                   c != '+' && c != 'M') {
            /* unexpected token character: tolerate (reference skips the
               field marker silently); treat as separator */
        }
        p++;
    }
    return p;
}

static const char *read_int(const char *p, const char *end, int64_t *out,
                            int *ok) {
    int neg;
    p = skip_to_int(p, end, &neg);
    if (p >= end) {
        *ok = 0;
        return p;
    }
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        p++;
    }
    *out = neg ? -v : v;
    *ok = 1;
    return p;
}

int64_t spasm_tpu_parse_sms(const char *buf, int64_t len, int64_t *header,
                            int64_t *out, int64_t cap) {
    const char *p = buf;
    const char *end = buf + len;
    int ok;
    int64_t n, m;
    p = read_int(p, end, &n, &ok);
    if (!ok) return -1;
    p = read_int(p, end, &m, &ok);
    if (!ok) return -1;
    header[0] = n;
    header[1] = m;
    int64_t count = 0;
    for (;;) {
        int64_t i, j, v;
        p = read_int(p, end, &i, &ok);
        if (!ok) break; /* EOF without terminator: tolerated */
        p = read_int(p, end, &j, &ok);
        if (!ok) return -1;
        p = read_int(p, end, &v, &ok);
        if (!ok) return -1;
        if (i == 0 && j == 0 && v == 0) break;
        if (count >= cap) return -1;
        out[3 * count] = i;
        out[3 * count + 1] = j;
        out[3 * count + 2] = v;
        count++;
    }
    return count;
}

/* ---- SMS writer: "i+1 j+1 v\n" lines for COO triples ----
 *
 * Native replacement for the Python-side serialization (io.py dumps_sms):
 * np.char string building cost 161 s at 53M nnz; the two-pass scheme here
 * (exact digit-count lengths -> prefix offsets -> parallel in-place
 * formatting) runs at memory speed.  The byte output is identical, so
 * matrix_hash (SHA-256 of the SMS serialization, the certificate
 * transcript anchor, src/SpaSM.jl:928-936) is unchanged. */

#ifdef _OPENMP
#include <omp.h>
#endif

static inline int sms_ndigits(int64_t x)
{
    int n = x < 0 ? 2 : 1;
    uint64_t u = x < 0 ? (uint64_t) (-(x + 1)) + 1 : (uint64_t) x;
    while (u >= 10) {
        u /= 10;
        n++;
    }
    return n;
}

static inline char *sms_write_i64(char *p, int64_t x)
{
    if (x < 0)
        *p++ = '-';
    uint64_t u = x < 0 ? (uint64_t) (-(x + 1)) + 1 : (uint64_t) x;
    char tmp[20];
    int n = 0;
    do {
        tmp[n++] = (char) ('0' + (u % 10));
        u /= 10;
    } while (u);
    while (n)
        *p++ = tmp[--n];
    return p;
}

/* lens[e] = byte length of line e ("(i+1) (j+1) v\n").  Returns total. */
int64_t spasm_tpu_sms_lengths(
    int64_t nnz, const int64_t *I, const int64_t *J, const int64_t *V,
    int64_t *lens)
{
    int64_t total = 0;
#pragma omp parallel for schedule(static) reduction(+:total)
    for (int64_t e = 0; e < nnz; e++) {
        int64_t l = sms_ndigits(I[e] + 1) + sms_ndigits(J[e] + 1)
            + sms_ndigits(V[e]) + 3;
        lens[e] = l;
        total += l;
    }
    return total;
}

/* offs[e] = start offset of line e (exclusive prefix of lens). */
void spasm_tpu_sms_fill(
    int64_t nnz, const int64_t *I, const int64_t *J, const int64_t *V,
    const int64_t *offs, char *buf)
{
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < nnz; e++) {
        char *p = buf + offs[e];
        p = sms_write_i64(p, I[e] + 1);
        *p++ = ' ';
        p = sms_write_i64(p, J[e] + 1);
        *p++ = ' ';
        p = sms_write_i64(p, V[e]);
        *p++ = '\n';
    }
}

/* ---- parallel body tokenizer ----
 *
 * Chunked variant of spasm_tpu_parse_sms: the body (everything after the
 * header line) splits at newline boundaries into per-thread chunks, each
 * parsed independently into its own slice of `out` (sized by the chunk's
 * newline count — one triple per line, which SMS writers produce; a
 * chunk overrunning its slice aborts the whole parse with -1 and the
 * caller falls back to the sequential tokenizer).  Trailing content
 * after the first all-zero triple is the caller's job to truncate
 * (matching the sequential parser, which stops at the terminator).
 * Returns total triples parsed, or -1 (malformed / capacity). */
int64_t spasm_tpu_parse_sms_par(const char *buf, int64_t len,
                                int64_t *header,
                                int64_t *oi, int64_t *oj, int64_t *ov,
                                int64_t cap, int64_t nchunks,
                                int64_t *chunk_counts,
                                int64_t *term_flags) {
    const char *p = buf;
    const char *end = buf + len;
    int ok;
    int64_t n, m;
    p = read_int(p, end, &n, &ok);
    if (!ok) return -1;
    p = read_int(p, end, &m, &ok);
    if (!ok) return -1;
    header[0] = n;
    header[1] = m;
    /* skip separators + the field-marker token ONLY (not the whole line):
     * the sequential parser and the NumPy fallback tokenize purely by
     * whitespace, so a degenerate layout whose first triple shares the
     * header line must not lose that triple.  Stop at the first digit or
     * sign — the start of the first triple, wherever it sits. */
    while (p < end && !(*p >= '0' && *p <= '9') && *p != '-')
        p++;
    const char *body = p;
    int64_t blen = end - body;
    if (nchunks < 1)
        nchunks = 1;
    /* chunk boundaries: advance to the next newline so no token straddles */
    const char **starts =
        (const char **) malloc(sizeof(char *) * (size_t) (nchunks + 1));
    int64_t *offs = (int64_t *) malloc(sizeof(int64_t) * (size_t) (nchunks + 1));
    if (!starts || !offs) {
        free(starts); free(offs);
        return -1;
    }
    starts[0] = body;
    for (int64_t c = 1; c < nchunks; c++) {
        const char *q = body + blen * c / nchunks;
        while (q < end && *q != '\n')
            q++;
        starts[c] = q < end ? q + 1 : end;
        if (starts[c] < starts[c - 1])
            starts[c] = starts[c - 1];
    }
    starts[nchunks] = end;
    for (int64_t c = 0; c < nchunks; c++)
        term_flags[c] = 0;
    /* per-chunk triple slots = newline count + 1 (one triple per line) */
    int fail = 0;
#pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < nchunks; c++) {
        int64_t lines = 1;
        for (const char *q = starts[c]; q < starts[c + 1]; q++)
            if (*q == '\n')
                lines++;
        offs[c + 1] = lines;
    }
    offs[0] = 0;
    for (int64_t c = 0; c < nchunks; c++)
        offs[c + 1] += offs[c];
    if (offs[nchunks] > cap)
        fail = 1;
#pragma omp parallel for schedule(static)
    for (int64_t c = 0; c < nchunks; c++) {
        if (fail) continue;
        const char *q = starts[c];
        const char *qe = starts[c + 1];
        int64_t base = offs[c], limit = offs[c + 1];
        int64_t cnt = 0;
        int okc;
        for (;;) {
            int64_t i, j, v;
            q = read_int(q, qe, &i, &okc);
            if (!okc) break;
            q = read_int(q, qe, &j, &okc);
            if (!okc) { cnt = -1; break; }
            q = read_int(q, qe, &v, &okc);
            if (!okc) { cnt = -1; break; }
            if (i == 0 && j == 0 && v == 0) {
                term_flags[c] = 1;  /* terminator: rest of chunk dropped */
                break;
            }
            if (base + cnt >= limit) { cnt = -1; break; }
            oi[base + cnt] = i;
            oj[base + cnt] = j;
            ov[base + cnt] = v;
            cnt++;
        }
        chunk_counts[c] = cnt;
        if (cnt < 0) {
#pragma omp atomic write
            fail = 1;
        }
    }
    if (fail) {
        free(starts); free(offs);
        return -1;
    }
    /* compact the per-chunk slices into one contiguous run (serial
     * memmove: destinations never overlap sources ahead of them).  A
     * chunk that hit the terminator ends the matrix: later chunks are
     * content past the terminator, dropped like the sequential parser
     * drops it. */
    int64_t total = 0;
    for (int64_t c = 0; c < nchunks; c++) {
        if (total != offs[c] && chunk_counts[c] > 0) {
            memmove(oi + total, oi + offs[c],
                    sizeof(int64_t) * (size_t) chunk_counts[c]);
            memmove(oj + total, oj + offs[c],
                    sizeof(int64_t) * (size_t) chunk_counts[c]);
            memmove(ov + total, ov + offs[c],
                    sizeof(int64_t) * (size_t) chunk_counts[c]);
        }
        total += chunk_counts[c];
        if (term_flags[c])
            break;  /* content past the terminator is dropped, like the
                     * sequential parser */
    }
    free(starts); free(offs);
    return total;
}
