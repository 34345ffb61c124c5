"""Rank certificates and probabilistic verification — the reference's
correctness subsystem (``sha256.c``, ``spasm_prng.c``,
``spasm_certificate.c``, src/SpaSM.jl:408-425, 926-936).

A certificate lets anyone check a claimed rank in O(nnz) time (a few SpMVs)
without redoing the elimination.  The protocol (same shape as the
reference's ``RankCertificate{r, prime, hash, i, j, x, y}``,
src/SpaSM.jl:345-353):

* the PRNG is SHA-256 in counter mode, seeded by (matrix hash, prime, seq)
  — deterministic, so the challenge vectors are non-interactive
  (Fiat-Shamir style);
* **rank >= r**: challenge u in F^r; the response x (values on the pivot
  rows i) satisfies (x @ A)[j] == u.  If the r x r pivot block were
  singular, a uniform u is reachable with probability <= 1/p.
* **rank <= r**: challenge v in F^n; the response y (values on i)
  satisfies y @ A[i] == v @ A.  If rank(A) > rank(A[i]), a uniform v
  escapes the span with probability >= 1 - 1/p.

``factorization_verify`` is the Freivalds check of A == L @ U
(``spasm_factorization_verify``, src/SpaSM.jl:936).

Bitstream compatibility with the reference's C PRNG: the wrapper quotes
the full ``spasm_prng_ctx`` layout (src/SpaSM.jl:355-372) —
``block[11]`` u32s with ``block[0:8] == H(matrix)``, ``block[8] = prime``,
``block[9] = counter``, ``block[10] = seq`` — and we reproduce exactly
that 44-byte counter-mode block here (see SpasmPRNG).  Three details are
NOT derivable from the quoted layout and are inferred (libspasm's C
sources and binaries are not present in this environment to check a
byte-for-byte match): (1) the memory endianness of the non-hash words
(we use little-endian, the x86/TPU-host native layout the struct would
have); (2) the output word convention for ``hash[8]`` (we use the SHA-256
state words, i.e. big-endian interpretation of the digest bytes); (3) the
rejection-sampling loop of ``spasm_prng_ZZp`` (we draw ``u32 & mask``
until ``< prime``).  Certificates remain self-consistent across
create/verify/save/load either way, and the protocol matches the
reference's; cross-verification of reference-produced certificate FILES
can only be confirmed once a libspasm build is available.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct

import numpy as np
import scipy.sparse as sp

from ._host.csr import SparseGFp
from .echelonize import LU, echelonize
from ._host.io import matrix_hash


class SpasmPRNG:
    """SHA-256 counter-mode PRNG seeded by (seed32, prime, seq)
    (``spasm_prng_seed`` / ``spasm_prng_u32`` / ``spasm_prng_ZZp``,
    src/SpaSM.jl:420-425)."""

    #: the four byte-convention candidates for the reference bitstream
    #: (see tools/prng_golden.py): ctx-word endianness x output-word
    #: convention.  Ours is LE-STATE; the others exist so a foreign
    #: (libspasm-produced) certificate can be verified under every
    #: candidate (tests/golden/prng_vectors.json pins all four).
    VARIANTS = ("LE-STATE", "LE-MEM", "BE-STATE", "BE-MEM")

    def __init__(self, seed: bytes, prime: int, seq: int = 0,
                 variant: str = "LE-STATE"):
        assert len(seed) == 32
        assert variant in self.VARIANTS
        self.variant = variant
        endian, words = variant.split("-")
        self._ctx_fmt = "<III" if endian == "LE" else ">III"
        self._out_fmt = ">8I" if words == "STATE" else "<8I"
        # the documented ctx block: H(matrix) | prime | counter | seq,
        # 11 u32 words = 44 bytes (src/SpaSM.jl:362-364); counter is
        # spliced in per refill
        self.seed = seed
        self.prime = prime
        self.seq = seq
        # mask = 2**i - 1 with i the smallest such that 2**i > prime
        i = max(1, int(prime).bit_length())
        if (1 << i) <= prime:
            i += 1
        self.mask = (1 << i) - 1
        self.counter = 0
        # unconsumed stream words, FIFO (ndarray: a Python int list cost
        # >1 s per certificate when millions of drawn words were pushed
        # back after a vector draw)
        self.buf: np.ndarray = np.zeros(0, np.uint64)

    @classmethod
    def simple(cls, prime: int, seed: int, seq: int = 0):
        """spasm_prng_seed_simple: integer seed."""
        return cls(hashlib.sha256(struct.pack("<Q", seed)).digest(),
                   prime, seq)

    def _refill(self):
        block = self.seed + struct.pack(
            self._ctx_fmt, self.prime & 0xFFFFFFFF, self.counter,
            self.seq & 0xFFFFFFFF)
        digest = hashlib.sha256(block).digest()
        self.counter += 1
        # default variant: hash[8] state words == big-endian digest words
        self.buf = np.concatenate(
            [self.buf,
             np.array(struct.unpack(self._out_fmt, digest), np.uint64)])

    def u32(self) -> int:
        if not self.buf.size:
            self._refill()
        w = int(self.buf[0])
        self.buf = self.buf[1:]
        return w

    def zzp(self) -> int:
        """Uniform field element, balanced representation."""
        while True:
            r = self.u32() & self.mask
            if r < self.prime:
                v = r
                return v - self.prime if v > self.prime // 2 else v

    def _block_words(self, nblocks: int) -> np.ndarray:
        """The next nblocks*8 u32 words of the counter-mode stream."""
        from ._host.native import prng_blocks_native

        if self.variant == "LE-STATE":  # the native kernel's convention
            words = prng_blocks_native(self.seed, self.prime & 0xFFFFFFFF,
                                       self.seq & 0xFFFFFFFF, self.counter,
                                       nblocks)
            if words is not None:  # csrc/prng_mod.c — hashlib-equivalence
                self.counter += nblocks  # tested; 1.8M hashlib calls->1 call
                return words.astype(np.uint64)
        pack = struct.pack
        sha = hashlib.sha256
        seed = self.seed
        pr = self.prime & 0xFFFFFFFF
        sq = self.seq & 0xFFFFFFFF
        raw = bytearray(nblocks * 32)
        ctx_fmt = self._ctx_fmt
        for b in range(nblocks):
            raw[b * 32:(b + 1) * 32] = sha(
                seed + pack(ctx_fmt, pr, self.counter, sq)).digest()
            self.counter += 1
        out_dtype = ">u4" if self._out_fmt == ">8I" else "<u4"
        return np.frombuffer(bytes(raw), dtype=out_dtype).astype(np.uint64)

    def zzp_vector(self, k: int) -> np.ndarray:
        """k field elements — bit-identical to k ``zzp()`` calls (same
        word stream, same rejection rule), vectorized: the per-element
        Python loop cost ~1.7 us/draw, which dominated certificate
        verification at n in the millions (8.9 s of a 9 s verify at d9)."""
        out = np.empty(k, np.int64)
        filled = 0
        p = self.prime
        half = p // 2
        mask = self.mask
        while filled < k:
            need = k - filled
            if self.buf.size:
                words = self.buf
                self.buf = np.zeros(0, np.uint64)
            else:
                # acceptance rate = p / (mask + 1) > 1/2; 5% margin on
                # the exact expected draw count
                acc_rate = self.prime / (self.mask + 1)
                nwords = int(need / acc_rate * 1.05) + 8
                nblocks = max(1, -(-nwords // 8))
                words = self._block_words(nblocks)
            masked = words & np.uint64(mask)
            acc = masked < np.uint64(p)
            vals = masked[acc]
            take = min(vals.size, need)
            v = vals[:take].astype(np.int64)
            out[filled:filled + take] = np.where(v > half, v - p, v)
            filled += take
            if filled >= k and take:
                # push unconsumed words (everything after the k-th
                # acceptance) back for subsequent scalar/vector draws
                last_word = np.flatnonzero(acc)[take - 1]
                self.buf = words[last_word + 1:].astype(np.uint64)
        return out


@dataclasses.dataclass
class RankCertificate:
    """src/SpaSM.jl:345-353."""

    r: int
    prime: int
    hash: bytes          # 32-byte SHA-256 matrix fingerprint
    i: np.ndarray        # (r,) pivot rows
    j: np.ndarray        # (r,) pivot cols
    x: np.ndarray        # (r,) response on rows i:  (x@A)[j] == u
    y: np.ndarray        # (r,) response on rows i:  y@A[i] == v@A


def certificate_rank_create(A: SparseGFp, hash_: bytes | None = None,
                            fact: LU | None = None,
                            variant: str = "LE-STATE", *,
                            device="cuda") -> RankCertificate:
    """``spasm_certificate_rank_create`` (src/SpaSM.jl:928).  ``variant``
    selects the PRNG byte convention (default: this framework's own
    bitstream; the other SpasmPRNG.VARIANTS emulate the candidate libspasm
    conventions for cross-verification testing).  Without a factorization
    with L, A is echelonized on ``device``; the solves then invert its
    dense-finish corner block there."""
    from .solve import _solve_zLp
    from ._host.elimination import wave_eliminate

    f = A.field
    if hash_ is None:
        hash_ = matrix_hash(A)
    if fact is None or fact.L is None:
        fact = echelonize(A, L=True, device=device)
    r = fact.r
    I, J = fact.p, fact.piv_cols
    prng = SpasmPRNG(hash_, f.p, seq=0, variant=variant)
    u = prng.zzp_vector(r)
    v = prng.zzp_vector(A.n)

    # x: solve x_I @ A[I, J] == u.  A[I] == Lp @ U, so A[I, J] = Lp @ U[:, J]
    # with U[:, J] unit *upper* triangular in pivot order (append
    # invariant).  Solve a @ U[:,J] = u by waves, then x_I @ Lp = a.
    TU = fact.U.select_cols(_col_selector(fact.qinv, J, A.m), r)
    levels = fact.levels
    res, Acoef = wave_eliminate(f, TU.to_scipy(), np.arange(r), levels,
                                sp.csr_matrix(u.reshape(1, -1)),
                                record_coeffs=True)
    assert res.nnz == 0
    Z = _solve_zLp(fact, Acoef)
    x = np.zeros(r, np.int64)
    Zc = Z.tocoo()
    x[Zc.col] = f.normalize(Zc.data)

    # y: v @ A == y_I @ A[I]:  v@A = (v@L)@U; need y_I @ Lp = v @ L
    c = fact.L.xapy(v)  # (r,)
    Z2 = _solve_zLp(fact, sp.csr_matrix(c.reshape(1, -1)))
    y = np.zeros(r, np.int64)
    Z2c = Z2.tocoo()
    y[Z2c.col] = f.normalize(Z2c.data)

    return RankCertificate(r=r, prime=f.p, hash=bytes(hash_),
                           i=I.astype(np.int64), j=J.astype(np.int64),
                           x=x, y=y)


def certificate_rank_verify(A: SparseGFp, hash_: bytes,
                            proof: RankCertificate,
                            variant: str = "LE-STATE") -> bool:
    """``spasm_certificate_rank_verify`` (src/SpaSM.jl:930) — O(nnz).

    ``variant`` selects the PRNG byte convention (SpasmPRNG.VARIANTS);
    the default is this framework's own bitstream.  Foreign certificate
    files can be checked under all four candidates (cli check_cert does)."""
    f = A.field
    if proof.prime != f.p or bytes(proof.hash) != bytes(hash_):
        return False
    r = proof.r
    if not (0 <= r <= min(A.n, A.m)):
        return False
    I, J = np.asarray(proof.i), np.asarray(proof.j)
    if (len(np.unique(I)) != r or len(np.unique(J)) != r
            or (r and (I.min() < 0 or I.max() >= A.n
                       or J.min() < 0 or J.max() >= A.m))):
        return False
    prng = SpasmPRNG(bytes(hash_), f.p, seq=0, variant=variant)
    u = prng.zzp_vector(r)
    v = prng.zzp_vector(A.n)
    # rank >= r:  (x @ A)[J] == u with x supported on I
    xa = _rows_combo(A, I, proof.x)
    if not np.array_equal(xa[J], f.normalize(u)):
        return False
    # rank <= r:  y @ A[I] == v @ A
    ya = _rows_combo(A, I, proof.y)
    va = A.xapy(v)
    return np.array_equal(ya, va)


def _rows_combo(A: SparseGFp, rows, coeffs):
    """(sum_k coeffs[k] * A[rows[k]]) as a dense length-m vector."""
    x_full = np.zeros(A.n, np.int64)
    x_full[np.asarray(rows, np.int64)] = np.asarray(coeffs, np.int64)
    return A.xapy(x_full)


def _col_selector(qinv, piv_cols, m):
    sel = np.full(m, -1, np.int64)
    sel[piv_cols] = qinv[piv_cols]
    return sel


def rank_certificate_save(proof: RankCertificate, path_or_file):
    """Text serialization (``spasm_rank_certificate_save``,
    src/SpaSM.jl:932)."""
    lines = [f"{proof.r} {proof.prime}", proof.hash.hex(),
             " ".join(map(str, proof.i)), " ".join(map(str, proof.j)),
             " ".join(map(str, proof.x)), " ".join(map(str, proof.y))]
    data = "\n".join(lines) + "\n"
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "w") as fh:
            fh.write(data)
    else:
        path_or_file.write(data)


def rank_certificate_load(path_or_file) -> RankCertificate:
    """``spasm_rank_certificate_load`` (src/SpaSM.jl:934)."""
    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file) as fh:
            text = fh.read()
    else:
        text = path_or_file.read()
    lines = text.strip().split("\n")
    r_s, p_s = lines[0].split()
    r = int(r_s)

    def vec(line):
        vals = line.split()
        assert len(vals) == r, "corrupt certificate"
        return np.array(vals, dtype=np.int64)

    return RankCertificate(
        r=r, prime=int(p_s), hash=bytes.fromhex(lines[1]),
        i=vec(lines[2]) if r else np.zeros(0, np.int64),
        j=vec(lines[3]) if r else np.zeros(0, np.int64),
        x=vec(lines[4]) if r else np.zeros(0, np.int64),
        y=vec(lines[5]) if r else np.zeros(0, np.int64))


def factorization_verify(A: SparseGFp, fact: LU, seed: int = 0,
                         n_iter: int = 2) -> bool:
    """Freivalds check of A == L @ U (``spasm_factorization_verify``,
    src/SpaSM.jl:936): random v, compare v @ A with (v @ L) @ U."""
    if fact.L is None:
        raise ValueError("factorization_verify requires L")
    f = A.field
    prng = SpasmPRNG.simple(f.p, seed)
    for _ in range(n_iter):
        v = prng.zzp_vector(A.n)
        va = A.xapy(v)
        vlu = fact.U.xapy(fact.L.xapy(v))
        if not np.array_equal(va, vlu):
            return False
    return True
