"""Matrix I/O: SMS triplet text format, SHA-256 matrix hashing, PNM bitmaps.

The SMS format (spasm_io.c analog, src/SpaSM.jl:498-549):

    <n> <m> M
    <i> <j> <v>        (1-based, arbitrary integers, mod-reduced on load)
    ...
    0 0 0

``load_sms(..., get_hash=True)`` also returns the SHA-256 hash of the raw
bytes consumed — this is the matrix fingerprint used to seed the certificate
PRNG (certificate.py).  ``matrix_hash`` of an in-memory matrix hashes its
canonical SMS serialization, so save -> load -> hash round-trips.

PNM rendering (spasm_save_pnm, src/SpaSM.jl:531-549): a downsampled picture
of the sparsity pattern — PBM (mode 1) bilevel, PGM (mode 2) grayscale
density, PPM (mode 3) colored by a Dulmage-Mendelsohn decomposition.
"""

from __future__ import annotations

import hashlib
import io as _io

import numpy as np

from .csr import SparseGFp, Triplet
from .field import DEFAULT_PRIME, field

# ---------------- SMS ----------------


def load_sms(path_or_file, p: int = DEFAULT_PRIME, get_hash: bool = False,
             csr: bool = True):
    """Load an SMS file.  Returns a SparseGFp (csr=True) or Triplet, plus the
    SHA-256 digest of the consumed bytes if get_hash.

    Values are reduced mod p on load (spasm_triplet_load semantics)."""
    close = False
    if isinstance(path_or_file, (str, bytes)):
        fh = open(path_or_file, "rb")
        close = True
    else:
        fh = path_or_file
    try:
        raw = fh.read()
    finally:
        if close:
            fh.close()
    if isinstance(raw, str):
        raw = raw.encode()
    digest = hashlib.sha256(raw).digest() if get_hash else None

    if len(raw.split(None, 3)) < 3:
        raise ValueError("truncated SMS file")

    from .native import parse_sms_native

    parsed = parse_sms_native(raw)
    if parsed is not None:
        n, m, i, j, v = parsed
        i, j = i - 1, j - 1
    else:
        tokens = raw.split()
        if len(tokens) < 3:
            raise ValueError("truncated SMS file")
        n = int(tokens[0])
        m = int(tokens[1])
        # tokens[2] is the field marker ('M'); silently skipped like the
        # reference's fast parser (src/SpaSM.jl:1063-1086)
        body = tokens[3:]
        if len(body) % 3:
            raise ValueError("SMS entry count not a multiple of 3")
        arr = np.array(body, dtype=np.int64).reshape(-1, 3)
        # find the 0 0 0 terminator
        stop = np.flatnonzero((arr == 0).all(axis=1))
        if stop.size:
            arr = arr[: stop[0]]
        i, j, v = arr[:, 0] - 1, arr[:, 1] - 1, arr[:, 2]

    f = field(p)
    if csr:
        mat = SparseGFp.from_coo(f, n, m, i, j, v)
    else:
        mat = Triplet(n, m, p)
        mat.i = list(i)
        mat.j = list(j)
        mat.v = list(f.normalize(v))
    return (mat, digest) if get_hash else mat


def dumps_sms(mat) -> bytes:
    """Canonical SMS serialization of a SparseGFp or Triplet.

    Values are written in the balanced representation, matching the
    reference's csr_save output of ZZp values."""
    buf = _io.BytesIO()
    if isinstance(mat, Triplet):
        n, m = mat.n, mat.m
        triples = zip(mat.i, mat.j, mat.v)
        buf.write(f"{n} {m} M\n".encode())
        for i, j, v in triples:
            buf.write(f"{i + 1} {j + 1} {v}\n".encode())
    else:
        buf.write(f"{mat.n} {mat.m} M\n".encode())
        i, j, v = mat.to_coo()
        from .native import format_sms_triples_native

        body = format_sms_triples_native(i, j, v)
        if body is not None:
            buf.write(body)
        else:
            lines = np.char.add(
                np.char.add((i + 1).astype("U12"), " "),
                np.char.add(np.char.add((j + 1).astype("U12"), " "),
                            v.astype("U12")))
            buf.write("\n".join(lines.tolist()).encode())
            if i.size:
                buf.write(b"\n")
    buf.write(b"0 0 0\n")
    return buf.getvalue()


def save_sms(mat, path_or_file):
    if isinstance(path_or_file, (str, bytes)):
        # stream header/body/terminator straight to the file — dumps_sms
        # would buffer the whole serialization through BytesIO +
        # getvalue (three GB-scale copies at 50M+ nnz)
        from .native import format_sms_triples_native

        if not isinstance(mat, Triplet):
            i, j, v = mat.to_coo()
            body = format_sms_triples_native(i, j, v)
            if body is not None:
                with open(path_or_file, "wb") as fh:
                    fh.write(f"{mat.n} {mat.m} M\n".encode())
                    fh.write(memoryview(body))
                    fh.write(b"0 0 0\n")
                return
        with open(path_or_file, "wb") as fh:
            fh.write(dumps_sms(mat))
    else:
        fh = path_or_file
        data = dumps_sms(mat)
        if hasattr(fh, "mode") and "b" not in getattr(fh, "mode", "b"):
            fh.write(data.decode())
        else:
            try:
                fh.write(data)
            except TypeError:
                fh.write(data.decode())


def matrix_hash(mat) -> bytes:
    """SHA-256 fingerprint of a matrix = hash of its canonical SMS bytes."""
    return hashlib.sha256(dumps_sms(mat)).digest()


# ---------------- PNM ----------------


def save_pnm(mat: SparseGFp, path_or_file, x=None, y=None, mode=2, dm=None):
    """Render the sparsity pattern as a PBM/PGM/PPM image of size y rows by
    x cols (downsampled).  mode: 1=PBM, 2=PGM, 3=PPM (colored by DM
    coarse decomposition when given)."""
    n, m = mat.shape
    x = min(m, 1000) if x is None else int(x)
    y = min(n, 1000) if y is None else int(y)
    x = max(1, min(x, m)) if m else 1
    y = max(1, min(y, n)) if n else 1
    i, j, _ = mat.to_coo()
    ci = (i * y // max(1, n)).astype(np.int64)
    cj = (j * x // max(1, m)).astype(np.int64)
    counts = np.zeros((y, x), dtype=np.int64)
    np.add.at(counts, (ci, cj), 1)

    if mode == 1:
        header = f"P4\n{x} {y}\n".encode()
        bits = np.packbits((counts > 0).astype(np.uint8), axis=1)
        body = bits.tobytes()
    elif mode == 2:
        cell = max(1, (n // y) * (m // x))
        dens = counts.astype(np.float64) / cell
        gray = 255 - np.minimum(255, (dens * 255 * 4)).astype(np.uint8)
        gray[counts == 0] = 255
        header = f"P5\n{x} {y}\n255\n".encode()
        body = gray.tobytes()
    elif mode == 3:
        img = np.full((y, x, 3), 255, dtype=np.uint8)
        filled = counts > 0
        img[filled] = (60, 60, 60)
        if dm is not None:
            img = _paint_dm(img, dm, n, m, y, x)
        header = f"P6\n{x} {y}\n255\n".encode()
        body = img.tobytes()
    else:
        raise ValueError(f"mode must be 1, 2 or 3, got {mode}")

    if isinstance(path_or_file, (str, bytes)):
        with open(path_or_file, "wb") as fh:
            fh.write(header + body)
    else:
        path_or_file.write(header + body)


def repr_png(mat: SparseGFp, maxsize: int = 500) -> bytes:
    """PNG bytes of the grayscale density picture of ``mat``'s sparsity
    pattern, longest side capped at ``maxsize`` (the notebook display
    analog of the reference's IJulia PGM rendering, src/SpaSM.jl:753-767,
    which uses the same 500-px cap and proportional downscale)."""
    import struct
    import zlib

    n, m = mat.shape
    y, x = max(1, n), max(1, m)
    if max(x, y) > maxsize:
        maxmn = max(x, y)
        y = max(1, y * maxsize // maxmn)
        x = max(1, x * maxsize // maxmn)
    i, j, _ = mat.to_coo()
    ci = (i * y // max(1, n)).astype(np.int64)
    cj = (j * x // max(1, m)).astype(np.int64)
    counts = np.zeros((y, x), dtype=np.int64)
    np.add.at(counts, (ci, cj), 1)
    cell = max(1, (n // y) * (m // x))
    dens = counts.astype(np.float64) / cell
    gray = 255 - np.minimum(255, (dens * 255 * 4)).astype(np.uint8)
    gray[counts == 0] = 255

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    # filter byte 0 (None) per scanline, 8-bit grayscale (color type 0)
    raw = np.concatenate(
        [np.zeros((y, 1), np.uint8), gray], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", x, y, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _paint_dm(img, dm, n, m, y, x):
    """Overlay the coarse DM decomposition blocks in distinct hues."""
    colors = [(255, 200, 200), (200, 255, 200), (200, 200, 255), (255, 255, 180)]
    rr, cc = dm.rr, dm.cc
    for k in range(min(4, len(rr) - 1)):
        r0, r1 = rr[k] * y // max(1, n), rr[k + 1] * y // max(1, n)
        c0, c1 = cc[k] * x // max(1, m), cc[k + 1] * x // max(1, m)
        block = img[r0:r1, c0:c1]
        bg = (block == 255).all(axis=-1)
        block[bg] = colors[k % len(colors)]
    return img
