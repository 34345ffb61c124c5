"""Round-granular checkpoint state and whole-factorization files: the
port of ``spasm_tpu/checkpoint.py``.

``save_state`` / ``load_state`` (the round state) and ``save_dense_state`` /
``load_dense_state`` (the dense finish's sidecar) are the reference's plain
numpy code, called by ``echelonize(checkpoint=, resume=)``; the files are
the reference's, so a checkpoint written by either package resumes in the
other.

``save_lu`` / ``load_lu`` write and read the reference's file format
(``"spasm_tpu_lu_v1"``), so a factorization saved by either package loads
in the other.

Format: one .npz per state (atomic rename), schema-versioned.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import scipy.sparse as sp

SCHEMA = 1


def save_state(path: str, *, field_p: int, round_idx: int, r: int,
               S, row_origin, U_sp, piv_cols, piv_origin, opts_dict,
               L_parts=None, L_rev_segments=()):
    """Persist an in-progress echelonization (atomic)."""
    S = sp.csr_matrix(S)
    U_sp = sp.csr_matrix(U_sp)
    payload = dict(
        schema=SCHEMA, field_p=field_p, round_idx=round_idx, r=r,
        S_shape=np.array(S.shape), S_indptr=S.indptr,
        S_indices=S.indices, S_data=S.data,
        row_origin=np.asarray(row_origin),
        U_shape=np.array(U_sp.shape), U_indptr=U_sp.indptr,
        U_indices=U_sp.indices, U_data=U_sp.data,
        piv_cols=np.asarray(piv_cols), piv_origin=np.asarray(piv_origin),
        opts_keys=np.array(sorted(opts_dict.keys())),
        opts_vals=np.array([float(opts_dict[k])
                            for k in sorted(opts_dict.keys())]),
    )
    if L_parts:
        payload["L_i"] = np.concatenate(
            [np.asarray(t[0], np.int64) for t in L_parts])
        payload["L_j"] = np.concatenate(
            [np.asarray(t[1], np.int64) for t in L_parts])
        payload["L_v"] = np.concatenate(
            [np.asarray(t[2], np.int64) for t in L_parts])
    if L_rev_segments:
        payload["L_seg"] = np.asarray(list(L_rev_segments), np.int64)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if int(z["schema"]) != SCHEMA:
            raise ValueError(f"unknown checkpoint schema {int(z['schema'])}")
        out = dict(
            field_p=int(z["field_p"]), round_idx=int(z["round_idx"]),
            r=int(z["r"]),
            S=sp.csr_matrix((z["S_data"], z["S_indices"], z["S_indptr"]),
                            shape=tuple(z["S_shape"])),
            row_origin=z["row_origin"],
            U=sp.csr_matrix((z["U_data"], z["U_indices"], z["U_indptr"]),
                            shape=tuple(z["U_shape"])),
            piv_cols=z["piv_cols"], piv_origin=z["piv_origin"],
            opts={str(k): float(v) for k, v in
                  zip(z["opts_keys"], z["opts_vals"])},
        )
        if "L_i" in z.files:
            out["L_parts"] = [(z["L_i"], z["L_j"], z["L_v"])]
        else:
            out["L_parts"] = []
        out["L_rev_segments"] = ([tuple(row) for row in z["L_seg"]]
                                 if "L_seg" in z.files else [])
    return out


# ---------------- dense-finish block-granular state ----------------
#
# The round-granular state above stops at the sparse rounds; a long dense
# finish (the d10-scale tail case) gets its own sidecar (`<path>.dense`)
# saved every few blocks by the blocked loops in echelonize.py.  The
# sidecar is validated against the finish inputs (prime, accumulated rank
# r0, tail nnz/shape) so a stale file from a different matrix or round is
# ignored rather than resumed.

DENSE_SCHEMA = 1


def save_dense_state(path: str, *, field_p: int, r0: int, s_nnz: int,
                     n_s: int, na: int, b0: int, Uh, piv_cols_loc,
                     piv_rows_glob, dry_blocks: int) -> None:
    """Persist mid-dense-finish state (atomic): the accumulated dense RREF
    `Uh` (rank_tail x na), the pivot bookkeeping, and the next block start
    `b0`."""
    Usp = sp.csr_matrix(np.asarray(Uh, np.int64))
    payload = dict(
        dense_schema=DENSE_SCHEMA, field_p=field_p, r0=r0, s_nnz=s_nnz,
        n_s=n_s, na=na, b0=b0, dry_blocks=dry_blocks,
        U_shape=np.array(Usp.shape), U_indptr=Usp.indptr,
        U_indices=Usp.indices, U_data=Usp.data,
        piv_cols_loc=np.asarray(piv_cols_loc, np.int64),
        piv_rows_glob=np.asarray(piv_rows_glob, np.int64),
    )
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_dense_state(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if int(z["dense_schema"]) != DENSE_SCHEMA:
            raise ValueError(
                f"unknown dense checkpoint schema {int(z['dense_schema'])}")
        U = sp.csr_matrix((z["U_data"], z["U_indices"], z["U_indptr"]),
                          shape=tuple(z["U_shape"]))
        return dict(
            field_p=int(z["field_p"]), r0=int(z["r0"]),
            s_nnz=int(z["s_nnz"]), n_s=int(z["n_s"]), na=int(z["na"]),
            b0=int(z["b0"]), dry_blocks=int(z["dry_blocks"]),
            Uh=np.asarray(U.todense(), np.int64),
            piv_cols_loc=z["piv_cols_loc"].tolist(),
            piv_rows_glob=z["piv_rows_glob"].tolist(),
        )


# ---------------- whole-factorization persistence ----------------
#
# The reference's persistence story is SMS matrix files + savable CSR
# factors (SURVEY.md section 5); round-granular state (above) goes beyond
# it.  save_lu/load_lu persist a finished LU (U, qinv, p, piv_cols,
# levels, optional L, dense_piv_start) as one compressed npz.


def save_lu(path: str, fact) -> None:
    """Persist a finished factorization (echelonize.LU)."""
    payload = dict(
        kind="spasm_tpu_lu_v1", field_p=fact.field.p, n=fact.n, m=fact.m,
        r=fact.r, complete=int(fact.complete),
        U_indptr=fact.U.indptr, U_indices=fact.U.indices,
        U_data=fact.U.data, qinv=fact.qinv, p_vec=fact.p,
        piv_cols=fact.piv_cols, levels=fact.levels,
        dense_piv_start=(-1 if fact.dense_piv_start is None
                         else fact.dense_piv_start))
    if fact.L is not None:
        payload.update(L_indptr=fact.L.indptr, L_indices=fact.L.indices,
                       L_data=fact.L.data)
        if fact.lp_order is not None:
            payload.update(lp_order=np.asarray(fact.lp_order, np.int64))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, path)


def load_lu(path: str, *, device="cuda"):
    """Load a factorization persisted by save_lu (by either package); its
    solves run their device work on ``device``."""
    from ._host.csr import SparseGFp
    from .echelonize import LU
    from ._host.field import field

    with np.load(path, allow_pickle=False) as z:
        if str(z["kind"]) != "spasm_tpu_lu_v1":
            raise ValueError(f"not a spasm_tpu LU file: {path}")
        f = field(int(z["field_p"]))
        n, m, r = int(z["n"]), int(z["m"]), int(z["r"])
        U = SparseGFp(f, r, m, z["U_indptr"].astype(np.int64),
                      z["U_indices"].astype(np.int32),
                      z["U_data"].astype(np.int32), _canonical=True)
        L = None
        if "L_indptr" in z:
            L = SparseGFp(f, n, r, z["L_indptr"].astype(np.int64),
                          z["L_indices"].astype(np.int32),
                          z["L_data"].astype(np.int32), _canonical=True)
        dps = int(z["dense_piv_start"])
        lp_order = (z["lp_order"].astype(np.int64)
                    if "lp_order" in z.files else None)
        return LU(field=f, n=n, m=m, r=r, complete=bool(int(z["complete"])),
                  U=U, qinv=z["qinv"].astype(np.int64),
                  p=z["p_vec"].astype(np.int64),
                  piv_cols=z["piv_cols"].astype(np.int64), L=L,
                  _levels=z["levels"].astype(np.int64),
                  dense_piv_start=None if dps < 0 else dps,
                  lp_order=lp_order, _device=str(device))
