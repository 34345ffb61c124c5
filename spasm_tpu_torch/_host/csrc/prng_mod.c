/* SHA-256 counter-mode PRNG block generator — the native engine of
 * certificate.py SpasmPRNG._block_words (the reference's spasm_prng_u32
 * counter-mode refill, src/SpaSM.jl:355-372,420-425).
 *
 * Each block hashes the 44-byte message
 *     seed[32] | u32le prime | u32le counter | u32le seq
 * and emits the 8 SHA-256 state words (== big-endian interpretation of
 * the digest bytes, exactly what the Python path unpacks with ">8I").
 * One message fits a single padded compression block (44 < 56), so a
 * block is ONE compression call; blocks are independent in the counter,
 * so the loop parallelizes.  The Python path made one hashlib call per
 * block (1.8M calls = ~5 s per d9 certificate); this runs the same
 * stream at memory speed.  Bit-compatibility is enforced by the
 * committed golden vectors (tests/golden/prng_vectors.json) and a
 * hashlib-equivalence test.
 *
 * SHA-256 compression per FIPS 180-4.
 */

#include <stdint.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

static const uint32_t K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
    0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u,
    0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u,
    0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u
};

#define ROTR(x, n) (((x) >> (n)) | ((x) << (32 - (n))))

static void sha256_compress(const uint8_t blk[64], uint32_t st[8])
{
    uint32_t w[64];
    for (int t = 0; t < 16; t++)
        w[t] = ((uint32_t) blk[4 * t] << 24) | ((uint32_t) blk[4 * t + 1] << 16)
             | ((uint32_t) blk[4 * t + 2] << 8) | (uint32_t) blk[4 * t + 3];
    for (int t = 16; t < 64; t++) {
        uint32_t s0 = ROTR(w[t - 15], 7) ^ ROTR(w[t - 15], 18)
            ^ (w[t - 15] >> 3);
        uint32_t s1 = ROTR(w[t - 2], 17) ^ ROTR(w[t - 2], 19)
            ^ (w[t - 2] >> 10);
        w[t] = w[t - 16] + s0 + w[t - 7] + s1;
    }
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
    for (int t = 0; t < 64; t++) {
        uint32_t S1 = ROTR(e, 6) ^ ROTR(e, 11) ^ ROTR(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = h + S1 + ch + K256[t] + w[t];
        uint32_t S0 = ROTR(a, 2) ^ ROTR(a, 13) ^ ROTR(a, 22);
        uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
        uint32_t t2 = S0 + mj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

/* out[b*8 + w] = state word w of block (counter0 + b). */
void spasm_tpu_prng_blocks(
    const uint8_t *seed, uint32_t prime, uint32_t seq,
    uint64_t counter0, int64_t nblocks, uint32_t *out)
{
    /* shared 64-byte template: 44-byte message + 0x80 pad + zeros +
     * 8-byte big-endian bit length (352) */
    uint8_t tmpl[64];
    memset(tmpl, 0, sizeof tmpl);
    memcpy(tmpl, seed, 32);
    tmpl[32] = (uint8_t) (prime & 0xff);
    tmpl[33] = (uint8_t) ((prime >> 8) & 0xff);
    tmpl[34] = (uint8_t) ((prime >> 16) & 0xff);
    tmpl[35] = (uint8_t) ((prime >> 24) & 0xff);
    tmpl[40] = (uint8_t) (seq & 0xff);
    tmpl[41] = (uint8_t) ((seq >> 8) & 0xff);
    tmpl[42] = (uint8_t) ((seq >> 16) & 0xff);
    tmpl[43] = (uint8_t) ((seq >> 24) & 0xff);
    tmpl[44] = 0x80;
    tmpl[62] = 0x01;            /* 352 = 0x0160 big-endian */
    tmpl[63] = 0x60;

#pragma omp parallel for schedule(static) if (nblocks > 4096)
    for (int64_t b = 0; b < nblocks; b++) {
        uint8_t blk[64];
        memcpy(blk, tmpl, 64);
        uint32_t ctr = (uint32_t) (counter0 + (uint64_t) b);
        blk[36] = (uint8_t) (ctr & 0xff);
        blk[37] = (uint8_t) ((ctr >> 8) & 0xff);
        blk[38] = (uint8_t) ((ctr >> 16) & 0xff);
        blk[39] = (uint8_t) ((ctr >> 24) & 0xff);
        uint32_t st[8] = {
            0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
            0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u
        };
        sha256_compress(blk, st);
        for (int w = 0; w < 8; w++)
            out[b * 8 + w] = st[w];
    }
}
