"""Loader for the framework's native (C) components.

Host-side paths worth native code (SURVEY.md section 7: "C++ only where
host-native speed is irreplaceable"):

* ``sms_parser.c`` — SMS text tokenizer;
* ``schur_mod.c`` — the OpenMP fused Schur update D = B - C @ U (mod p),
  the host analog of the reference's scatter/schur hot loop
  (src/SpaSM.jl:619-621, 758-770), used by the elimination waves.

Each shared library is compiled on first use from this package's csrc/
into ``build/spasm_tpu_torch/host/`` under the repository root, keyed by a
source hash; everything degrades gracefully to the NumPy/scipy
implementations if no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "spasm_tpu_torch", "host")
_libs: dict = {}


def _build(name: str, extra_flags=()):
    src = os.path.join(_CSRC, name + ".c")
    with open(src, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(_CACHE, exist_ok=True)
    sofile = os.path.join(_CACHE, f"{name}_{tag}.so")
    if not os.path.exists(sofile):
        cc = os.environ.get("CC", "cc")
        # a temporary of this process's own: test workers build at once
        tmp = f"{sofile}.{os.getpid()}.tmp"
        cmd = [cc, "-O3", "-shared", "-fPIC", *extra_flags, "-o", tmp, src]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, sofile)
    return ctypes.CDLL(sofile)


def _load(name: str, configure, extra_flags=()):
    if name not in _libs:
        lib = None
        if not os.environ.get("SPASM_TPU_NO_NATIVE"):
            try:
                lib = _build(name, extra_flags)
                configure(lib)
            except Exception as exc:  # pragma: no cover - env without cc
                lib = None
                if extra_flags:
                    # e.g. a toolchain without -fopenmp: the sources guard
                    # all OpenMP use behind #ifdef _OPENMP, so a serial
                    # build preserves the functionality
                    try:
                        lib = _build(name, ())
                        configure(lib)
                    except Exception:
                        lib = None
                if lib is None:
                    print(f"spasm_tpu_torch: native {name} unavailable "
                          f"({exc}); using NumPy fallback", file=sys.stderr)
        _libs[name] = lib
    return _libs[name]


def _configure_parser(lib):
    fn = lib.spasm_tpu_parse_sms
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64),
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    fn2 = lib.spasm_tpu_parse_sms_par
    fn2.restype = ctypes.c_int64
    fn2.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64)]
    _configure_sms_writer(lib)


def get_lib():
    return _load("sms_parser", _configure_parser, extra_flags=("-fopenmp",))


def parse_sms_native(raw: bytes):
    """Parse SMS bytes -> (n, m, i, j, v) or None if unavailable/invalid.

    Large inputs take the chunked OpenMP tokenizer (newline-aligned
    chunks, one triple per line); terminator semantics match the
    sequential parser — everything from the first all-zero triple on is
    dropped.  The sequential tokenizer is the small-input and fallback
    path."""
    lib = get_lib()
    if lib is None:
        return None
    header = (ctypes.c_int64 * 2)()
    if len(raw) >= (1 << 22):
        # capacity bound without scanning: every triple line is >= 6
        # bytes ("i j v\n"); bytes.count over a GB-scale buffer cost
        # ~1 s on its own.  np.empty reserves address space only — just
        # the parsed prefix is ever touched — and the returned arrays
        # are VIEWS (every load_sms consumer rewrites them: the 1-based
        # shift and the mod reduction both allocate fresh arrays).
        cap = len(raw) // 6 + 16
        nchunks = min(16, os.cpu_count() or 1)
        counts = np.zeros(nchunks, dtype=np.int64)
        flags = np.zeros(nchunks, dtype=np.int64)
        I64 = ctypes.POINTER(ctypes.c_int64)
        oi = np.empty(cap, dtype=np.int64)
        oj = np.empty(cap, dtype=np.int64)
        ov = np.empty(cap, dtype=np.int64)
        count = lib.spasm_tpu_parse_sms_par(
            raw, len(raw), header,
            oi.ctypes.data_as(I64), oj.ctypes.data_as(I64),
            ov.ctypes.data_as(I64), cap,
            nchunks, counts.ctypes.data_as(I64),
            flags.ctypes.data_as(I64))
        if count >= 0:
            return (int(header[0]), int(header[1]), oi[:count],
                    oj[:count], ov[:count])
    # upper bound on triples: one per newline
    cap = max(16, raw.count(b"\n") + 2)
    out = np.empty(3 * cap, dtype=np.int64)
    count = lib.spasm_tpu_parse_sms(
        raw, len(raw), header,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if count < 0:
        return None
    tri = out[:3 * count].reshape(-1, 3)
    return (int(header[0]), int(header[1]),
            tri[:, 0].copy(), tri[:, 1].copy(), tri[:, 2].copy())


# ---------------- fused Schur update: D = B - C @ U (mod p) ----------------

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _configure_schur(lib):
    fn = lib.spasm_tpu_schur_update
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   _I64P, _I32P, _I64P,
                   _I64P, _I32P, _I64P,
                   _I64P,
                   ctypes.POINTER(_I32P), ctypes.POINTER(_I64P)]
    lib.spasm_tpu_free.restype = None
    lib.spasm_tpu_free.argtypes = [ctypes.c_void_p]


def _csr_parts(A):
    """(indptr int64, indices int32, data int64) views/copies of a scipy
    csr, or None when indices exceed int32 (native path unsupported)."""
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    if A.indices.dtype != np.int32:
        if A.shape[1] > np.iinfo(np.int32).max:
            return None
        indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    else:
        indices = np.ascontiguousarray(A.indices)
    data = np.ascontiguousarray(A.data, dtype=np.int64)
    return indptr, indices, data


def schur_update_native(f, B, C, U):
    """Fused D = B - C @ U (mod p, balanced) via the OpenMP C kernel
    (csrc/schur_mod.c).  B (q, m), C (q, r), U (r, m) scipy csr with
    balanced int64 data.  Returns a canonical scipy csr, or None when the
    native library is unavailable (callers fall back to scipy)."""
    import scipy.sparse as sp

    lib = _load("schur_mod", _configure_schur, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    q, m = B.shape
    pb = _csr_parts(B)
    pc = _csr_parts(C)
    pu = _csr_parts(U)
    if pb is None or pc is None or pu is None:
        return None
    halfp = f.halfp
    # fast path accumulates raw int64 products; safe iff the worst-case
    # number of accumulated terms keeps |acc| < 2^62.  Each C entry adds
    # at most ONE product term to any single accumulator slot (its U row
    # contributes one value per column), so the per-slot term count is
    # bounded by the widest C row plus the B entry.
    safe_t = (1 << 62) // max(1, halfp * halfp)
    max_terms = 2 + int(np.diff(pc[0]).max(initial=0))
    reduce_each = 0 if max_terms < safe_t else 1
    outp = np.zeros(q + 1, dtype=np.int64)
    out_j = _I32P()
    out_x = _I64P()
    total = lib.spasm_tpu_schur_update(
        q, m, f.p, reduce_each,
        pb[0].ctypes.data_as(_I64P), pb[1].ctypes.data_as(_I32P),
        pb[2].ctypes.data_as(_I64P),
        pc[0].ctypes.data_as(_I64P), pc[1].ctypes.data_as(_I32P),
        pc[2].ctypes.data_as(_I64P),
        pu[0].ctypes.data_as(_I64P), pu[1].ctypes.data_as(_I32P),
        pu[2].ctypes.data_as(_I64P),
        outp.ctypes.data_as(_I64P),
        ctypes.byref(out_j), ctypes.byref(out_x))
    if total < 0:
        return None
    try:
        indices = np.ctypeslib.as_array(out_j, shape=(max(total, 1),))[
            :total].astype(np.int32, copy=True)
        data = np.ctypeslib.as_array(out_x, shape=(max(total, 1),))[
            :total].copy()
    finally:
        lib.spasm_tpu_free(out_j)
        lib.spasm_tpu_free(out_x)
    D = sp.csr_matrix((data, indices, outp), shape=(q, m))
    D.has_sorted_indices = True  # per-row column sort done in C
    return D


# ---------------- scatter reductions (pivot search hot loops) --------------

_F64P = ctypes.POINTER(ctypes.c_double)


def _configure_scatter(lib):
    for name, tp in (("scatter_min_i64", _I64P), ("scatter_min_f64", _F64P),
                     ("scatter_max_i64", _I64P), ("scatter_max_f64", _F64P),
                     ("scatter_add_i64", _I64P)):
        fn = getattr(lib, name)
        fn.restype = None
        ct = ctypes.c_int64 if tp is _I64P else ctypes.c_double
        fn.argtypes = [tp, ctypes.c_int64, _I64P, tp, ctypes.c_int64, ct]


def _scatter_lib():
    return _load("scatter_mod", _configure_scatter,
                 extra_flags=("-fopenmp",))


def _scatter(name, ufunc, identity, tgt, idx, val):
    """Dispatch one scatter reduction (np.<ufunc>.at semantics, in place)
    to the OpenMP kernel, falling back to ufunc.at."""
    lib = _scatter_lib()
    n = idx.shape[0]
    if (lib is None or n < (1 << 16) or not tgt.flags.c_contiguous):
        ufunc.at(tgt, idx, val)
        return
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=tgt.dtype)
    ptr = _I64P if tgt.dtype == np.int64 else _F64P
    getattr(lib, name)(
        tgt.ctypes.data_as(ptr), tgt.shape[0],
        idx.ctypes.data_as(_I64P), val.ctypes.data_as(ptr), n, identity)


def scatter_min(tgt, idx, val):
    """In-place np.minimum.at(tgt, idx, val), OpenMP-accelerated for large
    int64/float64 operands (csrc/scatter_mod.c)."""
    if tgt.dtype == np.int64:
        _scatter("scatter_min_i64", np.minimum, np.iinfo(np.int64).max,
                 tgt, idx, val)
    elif tgt.dtype == np.float64:
        _scatter("scatter_min_f64", np.minimum, np.inf, tgt, idx, val)
    else:
        np.minimum.at(tgt, idx, val)


def scatter_max(tgt, idx, val):
    """In-place np.maximum.at(tgt, idx, val) (int64/float64 native)."""
    if tgt.dtype == np.int64:
        _scatter("scatter_max_i64", np.maximum, np.iinfo(np.int64).min,
                 tgt, idx, val)
    elif tgt.dtype == np.float64:
        _scatter("scatter_max_f64", np.maximum, -np.inf, tgt, idx, val)
    else:
        np.maximum.at(tgt, idx, val)


def scatter_add(tgt, idx, val):
    """In-place np.add.at(tgt, idx, val) (int64 native path)."""
    if tgt.dtype == np.int64:
        _scatter("scatter_add_i64", np.add, 0, tgt, idx, val)
    else:
        np.add.at(tgt, idx, val)


def _configure_levels(lib):
    fn = lib.levels_from_sorted_edges
    fn.restype = None
    fn.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P]


def levels_from_sorted_edges(src, dst, r):
    """Longest-path levels for a src-ascending-sorted edge list with
    src < dst (one sequential C pass; see csrc/scatter_mod.c).  Returns
    None when the native library is unavailable."""
    lib = _load("scatter_mod", _configure_scatter,
                extra_flags=("-fopenmp",))
    if lib is None:
        return None
    if not hasattr(lib, "_levels_configured"):
        _configure_levels(lib)
        lib._levels_configured = True
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    levels = np.zeros(r, np.int64)
    lib.levels_from_sorted_edges(
        src.ctypes.data_as(_I64P), dst.ctypes.data_as(_I64P),
        src.shape[0], levels.ctypes.data_as(_I64P))
    return levels


def schur_update_qinv_native(f, B, qinv, U, rows=None):
    """Fused D = B[rows] - B[rows][:, piv_cols] @ U (mod p, balanced)
    with the coefficients read off B via qinv (csrc/schur_mod.c qinv
    variant) — no coefficient-submatrix materialization, and with
    ``rows`` given no row-subset gather either (output row i reads input
    row rows[i] inside the kernel).  qinv[j] = U row owning column j, or
    -1.  U must be mutually reduced with unit pivots.  Returns a
    canonical scipy csr or None (callers fall back)."""
    import scipy.sparse as sp

    lib = _load("schur_mod", _configure_schur, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    if not hasattr(lib, "_qinv_configured"):
        fn = lib.spasm_tpu_schur_update_qinv
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64,
                       _I64P, _I32P, _I64P,
                       _I64P, _I64P,
                       _I64P, _I32P, _I64P,
                       _I64P,
                       ctypes.POINTER(_I32P), ctypes.POINTER(_I64P)]
        lib._qinv_configured = True
    q, m = B.shape
    pb = _csr_parts(B)
    pu = _csr_parts(U)
    if pb is None or pu is None:
        return None
    qinv = np.ascontiguousarray(qinv, dtype=np.int64)
    if rows is not None:
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        q = rows.shape[0]
        rows_p = rows.ctypes.data_as(_I64P)
    else:
        rows_p = None
    halfp = f.halfp
    safe_t = (1 << 62) // max(1, halfp * halfp)
    max_terms = 2 + int(np.diff(pb[0]).max(initial=0))
    reduce_each = 0 if max_terms < safe_t else 1
    outp = np.zeros(q + 1, dtype=np.int64)
    out_j = _I32P()
    out_x = _I64P()
    total = lib.spasm_tpu_schur_update_qinv(
        q, m, f.p, reduce_each,
        pb[0].ctypes.data_as(_I64P), pb[1].ctypes.data_as(_I32P),
        pb[2].ctypes.data_as(_I64P),
        qinv.ctypes.data_as(_I64P), rows_p,
        pu[0].ctypes.data_as(_I64P), pu[1].ctypes.data_as(_I32P),
        pu[2].ctypes.data_as(_I64P),
        outp.ctypes.data_as(_I64P),
        ctypes.byref(out_j), ctypes.byref(out_x))
    if total < 0:
        return None
    try:
        indices = np.ctypeslib.as_array(out_j, shape=(max(total, 1),))[
            :total].astype(np.int32, copy=True)
        data = np.ctypeslib.as_array(out_x, shape=(max(total, 1),))[
            :total].copy()
    finally:
        lib.spasm_tpu_free(out_j)
        lib.spasm_tpu_free(out_x)
    D = sp.csr_matrix((data, indices, outp), shape=(q, m))
    D.has_sorted_indices = True
    return D


# ---------------- per-row left-looking GPLU (csrc/gplu_mod.c) --------------


def _configure_gplu(lib):
    fn = lib.spasm_tpu_gplu
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   ctypes.POINTER(_I64P), ctypes.POINTER(_I32P),
                   ctypes.POINTER(_I64P),
                   ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
                   ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
                   ctypes.POINTER(_I64P), _I64P]
    lib.spasm_tpu_gplu_free.restype = None
    lib.spasm_tpu_gplu_free.argtypes = [ctypes.c_void_p]


def gplu_native(f, S, record_l: bool):
    """Per-row left-looking sparse LU (csrc/gplu_mod.c) — bit-identical to
    echelonize._gplu_sequential's Python loop.  S: scipy csr with balanced
    int64 data.  Returns (indptr, indices, data, pcol, prow, Ltriples) with
    Ltriples = (li, lk, lv) or None; or None when the native library is
    unavailable / indices exceed int32."""
    lib = _load("gplu_mod", _configure_gplu)
    if lib is None:
        return None
    parts = _csr_parts(S)
    if parts is None:
        return None
    Sp, Sj, Sx = parts
    n, m = S.shape
    up = _I64P()
    uj = _I32P()
    ux = _I64P()
    pcol = _I64P()
    prow = _I64P()
    li = _I64P()
    lk = _I64P()
    lv = _I64P()
    lnnz = np.zeros(1, np.int64)
    r = lib.spasm_tpu_gplu(
        n, m, f.p, int(record_l),
        Sp.ctypes.data_as(_I64P), Sj.ctypes.data_as(_I32P),
        Sx.ctypes.data_as(_I64P),
        ctypes.byref(up), ctypes.byref(uj), ctypes.byref(ux),
        ctypes.byref(pcol), ctypes.byref(prow),
        ctypes.byref(li), ctypes.byref(lk), ctypes.byref(lv),
        lnnz.ctypes.data_as(_I64P))
    if r < 0:
        return None
    try:
        indptr = np.ctypeslib.as_array(up, shape=(r + 1,)).copy()
        unnz = int(indptr[-1]) if r else 0
        indices = np.ctypeslib.as_array(uj, shape=(max(unnz, 1),))[
            :unnz].copy()
        data = np.ctypeslib.as_array(ux, shape=(max(unnz, 1),))[
            :unnz].copy()
        pcol_a = (np.ctypeslib.as_array(pcol, shape=(max(r, 1),))[:r].copy()
                  if r else np.zeros(0, np.int64))
        prow_a = (np.ctypeslib.as_array(prow, shape=(max(r, 1),))[:r].copy()
                  if r else np.zeros(0, np.int64))
        ln = int(lnnz[0])
        ltrip = None
        if record_l and li and lk and lv:
            ltrip = (np.ctypeslib.as_array(li, shape=(max(ln, 1),))[
                         :ln].copy(),
                     np.ctypeslib.as_array(lk, shape=(max(ln, 1),))[
                         :ln].copy(),
                     np.ctypeslib.as_array(lv, shape=(max(ln, 1),))[
                         :ln].copy())
        elif record_l:
            ltrip = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                     np.zeros(0, np.int64))
    finally:
        for ptr in (up, uj, ux, pcol, prow, li, lk, lv):
            if ptr:
                lib.spasm_tpu_gplu_free(ptr)
    return indptr, indices, data, pcol_a, prow_a, ltrip


# ---------------- fused pivot-search scans (csrc/pivot_scan.c) -------------

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _configure_pivot_scan(lib):
    fn = lib.spasm_tpu_pivot_scan
    fn.restype = None
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I32P,
                   _U8P, _U8P, _F64P, _I32P, _U8P, _F64P]
    fn2 = lib.spasm_tpu_greedy_scan
    fn2.restype = ctypes.c_int64
    fn2.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I32P,
                    _U8P, _U8P, _F64P, _F64P, _U8P]


def _pivot_scan_lib():
    return _load("pivot_scan", _configure_pivot_scan,
                 extra_flags=("-fopenmp",))


def pivot_scan_native(indptr, indices, row_used, col_selected, pos_of_row):
    """One fused sweep computing the FL-cols candidates (topmost unused
    row per unselected column), the append-invariant hit flags, and the
    greedy col_touch_max state (csrc/pivot_scan.c).  Returns
    (min_row int32[m], hits uint8[n], col_touch_max float64[m]) or None
    when the native library is unavailable / indices exceed int32."""
    lib = _pivot_scan_lib()
    n = row_used.shape[0]
    m = col_selected.shape[0]
    if lib is None or max(n, m) >= np.iinfo(np.int32).max:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    row_used = np.ascontiguousarray(row_used, dtype=np.uint8)
    col_selected = np.ascontiguousarray(col_selected, dtype=np.uint8)
    pos_of_row = np.ascontiguousarray(pos_of_row, dtype=np.float64)
    min_row = np.full(m, n, dtype=np.int32)
    hits = np.zeros(n, dtype=np.uint8)
    col_touch_max = np.full(m, -np.inf, dtype=np.float64)
    lib.spasm_tpu_pivot_scan(
        n, m, indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
        row_used.ctypes.data_as(_U8P), col_selected.ctypes.data_as(_U8P),
        pos_of_row.ctypes.data_as(_F64P),
        min_row.ctypes.data_as(_I32P), hits.ctypes.data_as(_U8P),
        col_touch_max.ctypes.data_as(_F64P))
    return min_row, hits, col_touch_max


def levels_from_csr_native(indptr, indices, qinv, r):
    """Exact longest-path levels of an elimination-ordered pivot block,
    one sequential pass straight off the CSR (csrc/pivot_scan.c).
    Returns the levels array, None when the native library is
    unavailable; raises ValueError on an order violation (an entry
    hitting an EARLIER pivot's column) like the NumPy path."""
    lib = _pivot_scan_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_levels_csr_configured"):
        fn = lib.spasm_tpu_levels_from_csr
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_int64, _I64P, _I32P, _I64P, _I64P]
        lib._levels_csr_configured = True
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    qinv = np.ascontiguousarray(qinv, dtype=np.int64)
    levels = np.zeros(r, np.int64)
    rc = lib.spasm_tpu_levels_from_csr(
        r, indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
        qinv.ctypes.data_as(_I64P), levels.ctypes.data_as(_I64P))
    if rc < 0:
        raise ValueError("pivot list is not in elimination order")
    return levels


def greedy_scan_native(indptr, indices, row_used, col_selected,
                       piv_pos_of_col, col_touch_max):
    """Greedy first-pass eligibility flags per row (csrc/pivot_scan.c);
    returns (count, elig uint8[n]) or None when unavailable."""
    lib = _pivot_scan_lib()
    n = row_used.shape[0]
    m = col_selected.shape[0]
    if lib is None or max(n, m) >= np.iinfo(np.int32).max:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    row_used = np.ascontiguousarray(row_used, dtype=np.uint8)
    col_selected = np.ascontiguousarray(col_selected, dtype=np.uint8)
    piv_pos_of_col = np.ascontiguousarray(piv_pos_of_col, dtype=np.float64)
    col_touch_max = np.ascontiguousarray(col_touch_max, dtype=np.float64)
    elig = np.zeros(n, dtype=np.uint8)
    count = lib.spasm_tpu_greedy_scan(
        n, m, indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
        row_used.ctypes.data_as(_U8P), col_selected.ctypes.data_as(_U8P),
        piv_pos_of_col.ctypes.data_as(_F64P),
        col_touch_max.ctypes.data_as(_F64P), elig.ctypes.data_as(_U8P))
    return int(count), elig


def _configure_greedy(lib):
    fn = lib.spasm_tpu_greedy_pivots
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I32P,
                   _U8P, _U8P, _F64P, _F64P, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _F64P]


def greedy_pivots_native(indptr, indices, col_selected, row_used,
                         piv_pos_of_col, col_touch_max, max_passes=2,
                         mopup=True, cap=4096):
    """The greedy cycle-free completion of ``pivots.greedy_pivots``, its
    batched passes and its sequential mop-up, in one call
    (csrc/greedy_mod.c, a source of the port alone).  Reads the CSR and
    updates the four state arrays in place (bool ``col_selected`` /
    ``row_used``, float64 positions, all C-contiguous), bit-identically to
    the NumPy formulation.  Returns (rows, cols, pos), or None when the
    native library is unavailable, the indices exceed int32 or a state
    array cannot be updated in place; the state is then unchanged."""
    lib = _load("greedy_mod", _configure_greedy, extra_flags=("-fopenmp",))
    n = row_used.shape[0]
    m = col_selected.shape[0]
    if lib is None or max(n, m) >= np.iinfo(np.int32).max:
        return None
    for a, dt in ((col_selected, np.bool_), (row_used, np.bool_),
                  (piv_pos_of_col, np.float64), (col_touch_max, np.float64)):
        if a.dtype != dt or not a.flags.c_contiguous or not a.flags.writeable:
            return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    cap_out = min(n, m)
    rows = np.empty(cap_out, np.int64)
    cols = np.empty(cap_out, np.int64)
    pos = np.empty(cap_out, np.float64)
    count = lib.spasm_tpu_greedy_pivots(
        n, m, indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
        col_selected.ctypes.data_as(_U8P), row_used.ctypes.data_as(_U8P),
        piv_pos_of_col.ctypes.data_as(_F64P),
        col_touch_max.ctypes.data_as(_F64P), max_passes, int(mopup), cap,
        rows.ctypes.data_as(_I64P), cols.ctypes.data_as(_I64P),
        pos.ctypes.data_as(_F64P))
    if count < 0:
        return None
    return rows[:count].copy(), cols[:count].copy(), pos[:count].copy()


def _configure_schur_ranged(lib):
    fn = lib.spasm_tpu_schur_update_ranged
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   _I64P, ctypes.c_int64, ctypes.c_int64,
                   _I64P,
                   ctypes.POINTER(_I32P), ctypes.POINTER(_I64P)]


def schur_update_ranged_native(f, Pp, Pj, Px, q, m, qinv, klo, khi):
    """D = P[0:q] - coeffs @ P[klo:khi] with coefficients read off P via
    qinv (csrc/schur_mod.c ranged variant — no prefix/coefficient
    materialization).  Returns (indptr, indices, data) with int64/int32/
    int64 dtypes, or None when the native library is unavailable."""
    lib = _load("schur_mod", _configure_schur, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    if not hasattr(lib, "_ranged_configured"):
        _configure_schur_ranged(lib)
        lib._ranged_configured = True
    Pp = np.ascontiguousarray(Pp, dtype=np.int64)
    Pj = np.ascontiguousarray(Pj, dtype=np.int32)
    Px = np.ascontiguousarray(Px, dtype=np.int64)
    qinv = np.ascontiguousarray(qinv, dtype=np.int64)
    halfp = f.halfp
    safe_t = (1 << 62) // max(1, halfp * halfp)
    max_terms = 2 + int(np.diff(Pp[:q + 1]).max(initial=0))
    reduce_each = 0 if max_terms < safe_t else 1
    outp = np.zeros(q + 1, dtype=np.int64)
    out_j = _I32P()
    out_x = _I64P()
    total = lib.spasm_tpu_schur_update_ranged(
        q, m, f.p, reduce_each,
        Pp.ctypes.data_as(_I64P), Pj.ctypes.data_as(_I32P),
        Px.ctypes.data_as(_I64P),
        qinv.ctypes.data_as(_I64P), klo, khi,
        outp.ctypes.data_as(_I64P),
        ctypes.byref(out_j), ctypes.byref(out_x))
    if total < 0:
        return None
    try:
        indices = np.ctypeslib.as_array(out_j, shape=(max(total, 1),))[
            :total].astype(np.int32, copy=True)
        data = np.ctypeslib.as_array(out_x, shape=(max(total, 1),))[
            :total].copy()
    finally:
        lib.spasm_tpu_free(out_j)
        lib.spasm_tpu_free(out_x)
    return outp, indices, data


def _configure_mutual(lib):
    fn = lib.spasm_tpu_mutual_reduce
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   _I64P, _I64P, ctypes.c_int64,
                   ctypes.c_int64, _I64P,
                   _I64P,
                   ctypes.POINTER(_I32P), ctypes.POINTER(_I64P)]
    lib.spasm_tpu_mr_free.restype = None
    lib.spasm_tpu_mr_free.argtypes = [ctypes.c_void_p]


def mutual_reduce_native(f, W, qinv, offs, depth, nnz_cap, rowperm=None):
    """Full mutual reduction (block RREF) of the ordered pivot block W in
    ONE native call (csrc/mutual_mod.c): each row finalized exactly once
    against already-final higher-level rows, instead of the per-level
    prefix rewrite of the ranged sweep.  qinv[j] = level-sorted row index
    owning column j (or -1); offs = level offsets (depth+1).  With
    rowperm given (level-sorted position -> W row), W itself stays in its
    original row order: the kernel permutes on read and emits the result
    back in original order (no gather in, no inverse gather out).
    Returns a canonical scipy csr, False on fill-cap blow-up, or None
    when the native library is unavailable (callers fall back)."""
    import scipy.sparse as sp

    lib = _load("mutual_mod", _configure_mutual, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    pw = _csr_parts(W)
    if pw is None:
        return None
    r, m = W.shape
    qinv = np.ascontiguousarray(qinv, dtype=np.int64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    halfp = f.halfp
    safe_t = (1 << 62) // max(1, halfp * halfp)
    # terms per output <= 1 + hits(row) <= 1 + max row nnz of W (each
    # referenced FINAL row contributes one product per output column)
    max_terms = 2 + int(np.diff(pw[0]).max(initial=0))
    reduce_each = 0 if max_terms < safe_t else 1
    outp = np.zeros(r + 1, dtype=np.int64)
    out_j = _I32P()
    out_x = _I64P()
    if rowperm is not None:
        rowperm = np.ascontiguousarray(rowperm, dtype=np.int64)
        perm_p = rowperm.ctypes.data_as(_I64P)
    else:
        perm_p = None
    total = lib.spasm_tpu_mutual_reduce(
        r, m, f.p, reduce_each,
        pw[0].ctypes.data_as(_I64P), pw[1].ctypes.data_as(_I32P),
        pw[2].ctypes.data_as(_I64P),
        qinv.ctypes.data_as(_I64P), offs.ctypes.data_as(_I64P),
        depth, nnz_cap if nnz_cap is not None else 0, perm_p,
        outp.ctypes.data_as(_I64P),
        ctypes.byref(out_j), ctypes.byref(out_x))
    if total == -2:
        return False
    if total < 0:
        return None
    try:
        indices = np.ctypeslib.as_array(out_j, shape=(max(total, 1),))[
            :total].astype(np.int32, copy=True)
        data = np.ctypeslib.as_array(out_x, shape=(max(total, 1),))[
            :total].copy()
    finally:
        lib.spasm_tpu_mr_free(out_j)
        lib.spasm_tpu_mr_free(out_x)
    D = sp.csr_matrix((data, indices, outp), shape=(r, m))
    D.has_sorted_indices = True
    return D


def _configure_cascade(lib):
    fn = lib.spasm_tpu_cascade_nnz
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   _I64P, _I32P, _I64P,
                   _I64P, _I64P]
    _configure_cascade_elim(lib)


def cascade_nnz_native(f, sample, U, piv_cols):
    """Total surviving nnz of the sample rows eliminated against the
    ordered pivot block U (unit pivots, append invariant) via the per-row
    heap cascade (csrc/cascade_mod.c) — the Schur density estimator's
    engine.  Returns the count, or None when unavailable."""
    lib = _load("cascade_mod", _configure_cascade)
    if lib is None:
        return None
    ps = _csr_parts(sample)
    pu = _csr_parts(U)
    if ps is None or pu is None:
        return None
    r = U.shape[0]
    m = U.shape[1]
    piv_cols = np.ascontiguousarray(piv_cols, dtype=np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)
    total = lib.spasm_tpu_cascade_nnz(
        sample.shape[0], m, r, f.p,
        ps[0].ctypes.data_as(_I64P), ps[1].ctypes.data_as(_I32P),
        ps[2].ctypes.data_as(_I64P),
        pu[0].ctypes.data_as(_I64P), pu[1].ctypes.data_as(_I32P),
        pu[2].ctypes.data_as(_I64P),
        qinv.ctypes.data_as(_I64P), piv_cols.ctypes.data_as(_I64P))
    if total < 0:
        return None
    return int(total)


def _configure_rowops(lib):
    fn = lib.spasm_tpu_gather_rows
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, _I64P,
                   _I64P, _I32P, _I64P,
                   _I64P, _I32P, _I64P]
    fn2 = lib.spasm_tpu_scale_rows
    fn2.restype = None
    fn2.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P,
                    ctypes.c_int64, ctypes.c_int64]
    fn3 = lib.spasm_tpu_normalize_i64
    fn3.restype = None
    fn3.argtypes = [ctypes.c_int64, _I64P, ctypes.c_int64, _I64P]


def gather_rows_native(S, rows):
    """S[rows] as a fresh canonical csr via the OpenMP row gather
    (csrc/rowops_mod.c), or None when unavailable."""
    import scipy.sparse as sp

    lib = _load("rowops_mod", _configure_rowops, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    ps = _csr_parts(S)
    if ps is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    nr = rows.shape[0]
    outp = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(ps[0][rows + 1] - ps[0][rows], out=outp[1:])
    total = int(outp[nr])
    out_j = np.empty(max(total, 1), dtype=np.int32)
    out_x = np.empty(max(total, 1), dtype=np.int64)
    lib.spasm_tpu_gather_rows(
        nr, rows.ctypes.data_as(_I64P),
        ps[0].ctypes.data_as(_I64P), ps[1].ctypes.data_as(_I32P),
        ps[2].ctypes.data_as(_I64P),
        outp.ctypes.data_as(_I64P), out_j.ctypes.data_as(_I32P),
        out_x.ctypes.data_as(_I64P))
    D = sp.csr_matrix((out_x[:total], out_j[:total], outp),
                      shape=(nr, S.shape[1]))
    D.has_sorted_indices = S.has_sorted_indices
    return D


def scale_rows_native(f, A, scale, normalize):
    """In-place A.data[row slice] *= scale[row] (csrc/rowops_mod.c);
    balanced mod-p when normalize, raw product otherwise (the +-1 fast
    path).  A.data must be int64.  Returns True, or None when
    unavailable (caller falls back to the numpy repeat/gather)."""
    lib = _load("rowops_mod", _configure_rowops, extra_flags=("-fopenmp",))
    if lib is None or A.data.dtype != np.int64 or not A.data.flags.c_contiguous:
        return None
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    scale = np.ascontiguousarray(scale, dtype=np.int64)
    lib.spasm_tpu_scale_rows(
        A.shape[0], indptr.ctypes.data_as(_I64P),
        A.data.ctypes.data_as(_I64P), scale.ctypes.data_as(_I64P),
        f.p, 1 if normalize else 0)
    return True


def _configure_sms_writer(lib):
    fn = lib.spasm_tpu_sms_lengths
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P, _I64P]
    fn2 = lib.spasm_tpu_sms_fill
    fn2.restype = None
    fn2.argtypes = [ctypes.c_int64, _I64P, _I64P, _I64P, _I64P,
                    ctypes.c_char_p]


def format_sms_triples_native(i, j, v):
    """SMS body '(i+1) (j+1) v\\n' per triple via the two-pass OpenMP
    formatter (csrc/sms_parser.c writer) — byte-identical to the numpy
    string path in io.dumps_sms (161 s -> ~2 s at 53M nnz).  Returns a
    uint8 array (hashlib/BytesIO accept it zero-copy via memoryview), or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    i = np.ascontiguousarray(i, dtype=np.int64)
    j = np.ascontiguousarray(j, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    nnz = i.shape[0]
    lens = np.empty(nnz, dtype=np.int64)
    total = lib.spasm_tpu_sms_lengths(
        nnz, i.ctypes.data_as(_I64P), j.ctypes.data_as(_I64P),
        v.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P))
    offs = np.empty(nnz, dtype=np.int64)
    if nnz:
        offs[0] = 0
        np.cumsum(lens[:-1], out=offs[1:])
    buf = np.empty(int(total), dtype=np.uint8)
    lib.spasm_tpu_sms_fill(
        nnz, i.ctypes.data_as(_I64P), j.ctypes.data_as(_I64P),
        v.ctypes.data_as(_I64P), offs.ctypes.data_as(_I64P),
        buf.ctypes.data_as(ctypes.c_char_p))
    return buf


def _configure_cascade_elim(lib):
    fn = lib.spasm_tpu_cascade_eliminate
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64,
                   _I64P, _I32P, _I64P,
                   _I64P, _I32P, _I64P,
                   _I64P, _I64P,
                   _I64P, ctypes.POINTER(_I32P), ctypes.POINTER(_I64P),
                   _I64P, ctypes.POINTER(_I64P), ctypes.POINTER(_I64P)]
    lib.spasm_tpu_casc_free.restype = None
    lib.spasm_tpu_casc_free.argtypes = [ctypes.c_void_p]


def cascade_eliminate_native(f, B, U, piv_cols):
    """Few-row elimination of B against the ordered pivot block U (unit
    pivots, append invariant) via the per-row heap cascade with
    coefficient recording (csrc/cascade_mod.c): returns (D, C) with
    D = B - C @ U (mod p, zeros at every pivot column), the same unique
    decomposition wave_eliminate computes, without the per-level slicing
    and O(m) sorts.  Returns None when unavailable."""
    import scipy.sparse as sp

    lib = _load("cascade_mod", _configure_cascade)
    if lib is None:
        return None
    pb = _csr_parts(B)
    pu = _csr_parts(U)
    if pb is None or pu is None:
        return None
    q = B.shape[0]
    r, m = U.shape
    piv_cols = np.ascontiguousarray(piv_cols, dtype=np.int64)
    qinv = np.full(m, -1, np.int64)
    qinv[piv_cols] = np.arange(r)
    res_p = np.zeros(q + 1, dtype=np.int64)
    coef_p = np.zeros(q + 1, dtype=np.int64)
    rjp = _I32P()
    rxp = _I64P()
    ckp = _I64P()
    ccp = _I64P()
    total = lib.spasm_tpu_cascade_eliminate(
        q, m, r, f.p,
        pb[0].ctypes.data_as(_I64P), pb[1].ctypes.data_as(_I32P),
        pb[2].ctypes.data_as(_I64P),
        pu[0].ctypes.data_as(_I64P), pu[1].ctypes.data_as(_I32P),
        pu[2].ctypes.data_as(_I64P),
        qinv.ctypes.data_as(_I64P), piv_cols.ctypes.data_as(_I64P),
        res_p.ctypes.data_as(_I64P), ctypes.byref(rjp),
        ctypes.byref(rxp),
        coef_p.ctypes.data_as(_I64P), ctypes.byref(ckp),
        ctypes.byref(ccp))
    if total < 0:
        return None
    nc = int(coef_p[q])
    try:
        rj = np.ctypeslib.as_array(rjp, shape=(max(total, 1),))[
            :total].astype(np.int32, copy=True)
        rx = np.ctypeslib.as_array(rxp, shape=(max(total, 1),))[
            :total].copy()
        ck = np.ctypeslib.as_array(ckp, shape=(max(nc, 1),))[:nc].copy()
        cc = np.ctypeslib.as_array(ccp, shape=(max(nc, 1),))[:nc].copy()
    finally:
        lib.spasm_tpu_casc_free(rjp)
        lib.spasm_tpu_casc_free(rxp)
        lib.spasm_tpu_casc_free(ckp)
        lib.spasm_tpu_casc_free(ccp)
    D = sp.csr_matrix((rx, rj, res_p), shape=(q, m))
    D.has_sorted_indices = True
    C = sp.csr_matrix((cc, ck.astype(np.int32), coef_p), shape=(q, r),
                      dtype=np.int64)
    C.has_sorted_indices = True
    return D, C


def _configure_prng(lib):
    fn = lib.spasm_tpu_prng_blocks
    fn.restype = None
    fn.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_uint64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_uint32)]


def prng_blocks_native(seed, prime, seq, counter, nblocks):
    """nblocks*8 SHA-256 counter-mode state words (csrc/prng_mod.c) —
    bit-identical to hashlib over the 44-byte spasm_prng_ctx block
    (certificate.py SpasmPRNG).  Returns a uint32 array, or None when
    unavailable."""
    if counter + nblocks > 1 << 32:
        # the 44-byte ctx block stores the counter as a u32; the C kernel
        # would silently wrap and repeat the stream — refuse instead, so
        # the hashlib fallback fails loudly via struct.pack('<I')
        return None
    lib = _load("prng_mod", _configure_prng, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    out = np.empty(nblocks * 8, dtype=np.uint32)
    lib.spasm_tpu_prng_blocks(
        bytes(seed), prime, seq, counter, nblocks,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def normalize_i64_native(x, p):
    """Balanced mod-p reduction of a contiguous int64 vector in one OpenMP
    pass (csrc/rowops_mod.c) — same result as Field.normalize's numpy
    chain.  Returns a fresh int64 array, or None when unavailable."""
    lib = _load("rowops_mod", _configure_rowops, extra_flags=("-fopenmp",))
    if lib is None:
        return None
    out = np.empty(x.shape[0], dtype=np.int64)
    lib.spasm_tpu_normalize_i64(
        x.shape[0], x.ctypes.data_as(_I64P), p,
        out.ctypes.data_as(_I64P))
    return out


def _configure_trisolve(lib):
    for name in ("spasm_tpu_dense_back_solve",
                 "spasm_tpu_dense_forward_solve"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _I64P, _I32P, _I32P,
                       _I64P, _I64P, _I64P, ctypes.c_int64]


def dense_trisolve_native(kind, A, b, perm, p):
    """Sequential dense-RHS permuted triangular solve (csrc/trisolve_mod.c)
    — the native port of solve.py's dense_back_solve / dense_forward_solve
    loops.  kind: 'back' (x @ L == b, diag located by perm=p) or 'forward'
    (x @ U == b, unit pivots located by perm=q).  Returns the solution
    vector, None if unsolvable, or NotImplemented when the native library
    is unavailable (caller falls back to the Python loop)."""
    lib = _load("trisolve_mod", _configure_trisolve)
    if lib is None:
        return NotImplemented
    b = np.ascontiguousarray(b, dtype=np.int64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.int32)
    x = np.zeros(A.shape[0], dtype=np.int64)
    fn = (lib.spasm_tpu_dense_back_solve if kind == "back"
          else lib.spasm_tpu_dense_forward_solve)
    rc = fn(A.shape[0], A.shape[1],
            indptr.ctypes.data_as(_I64P), indices.ctypes.data_as(_I32P),
            data.ctypes.data_as(_I32P), perm.ctypes.data_as(_I64P),
            b.ctypes.data_as(_I64P), x.ctypes.data_as(_I64P), p)
    return None if rc else x


def release_native_scratch():
    """Free the persistent per-thread SPA arenas of the Schur kernels
    (csrc/schur_mod.c spasm_tpu_spa_release).  They are sized to the
    largest column count ever processed and otherwise retained for the
    life of the process (the same policy as the tuned malloc high-water
    mark, utils/hostmem.py); long-lived embedders can call this after a
    one-off huge problem.  No-op when the native library is absent."""
    lib = _libs.get("schur_mod")
    if lib is None:
        return
    if not hasattr(lib, "_release_configured"):
        lib.spasm_tpu_spa_release.restype = None
        lib.spasm_tpu_spa_release.argtypes = []
        lib._release_configured = True
    lib.spasm_tpu_spa_release()
