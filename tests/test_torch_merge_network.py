"""A numpy model of K3's schedule: the register kernel ``merge_rows_kernel<E>``
of ``spasm_tpu_torch/csrc/merge.cu``, which cannot run on the CPU.

The model follows the kernel step for step: the CTA-to-row packing, the
load map (lane t, register e reads slot e T + t, or with 16-byte loads
slot 4 i T + 4 t + q for e = 4 i + q: any order will do, the network sorts
it), the blocked layout of the sorted row (lane t, register e holds slot
t E + e) and the striped layout of the cross-warp stages (shared-memory
index e T + t), the level
at which each (k, j) stage of the bitonic network runs (registers, warp
shuffle, shared memory), the direction each lane takes, and the scan: the
lane's serial aggregate, the segmented shuffle scan, the warps' carry and
the second pass that writes the outputs.  It reads E and the packing from
merge.cu's ``constexpr`` lines and fails when they change without it.
Every Wp from 2 to 16384 must sort all-0/1 rows (the 0-1 principle) and
random rows, and the modelled outputs must equal ``merge_rows_plain`` bit
for bit (GF(p): tolerance 0).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spasm_tpu_torch import field
from spasm_tpu_torch.ops.merge import merge_rows_plain

SRC = (Path(__file__).resolve().parents[1] / "spasm_tpu_torch" / "csrc"
       / "merge.cu")
# the layout this model implements: keys per lane, the fewest lanes of a
# row, threads of a CTA of narrow rows, widest row of the register kernel
MODELLED = {"kKeysPerLane": 32, "kMinRowLanes": 2, "kCtaThreads": 128,
            "kMaxSmemSlots": 16384}
WARP = 32
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)
WPS = [1 << q for q in range(1, 15)]          # 2 .. 16384


@pytest.fixture(scope="module")
def layout():
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SRC.read_text())}
    return {k: consts[k] for k in MODELLED}


def geometry(Wp, lay):
    """E, T (lanes of a row), seg (lanes of a row inside one warp),
    threads of a CTA and rows of a CTA, as merge_rows_kernel / launch_rows
    compute them."""
    lanes_e = Wp // lay["kMinRowLanes"] if Wp > lay["kMinRowLanes"] else 1
    E = min(lanes_e, lay["kKeysPerLane"])
    T = Wp // E
    threads = T if T > WARP else lay["kCtaThreads"]
    return E, T, min(T, WARP), threads, threads // T


def load_map(T, E, vec):
    """(T, E) slot index that lane t, register e loads."""
    t, e = np.meshgrid(np.arange(T), np.arange(E), indexing="ij")
    return (e // 4) * 4 * T + 4 * t + e % 4 if vec else e * T + t


def level(j, E):
    return ("register" if j < E else "shuffle" if j < WARP * E
            else "shared")


def stages(Wp):
    k = 2
    while k <= Wp:
        j = k // 2
        while j:
            yield k, j
            j //= 2
        k *= 2


def test_model_mirrors_kernel_layout(layout):
    # a change of merge.cu's layout constants must come with the model's
    assert layout == MODELLED


@pytest.mark.parametrize("Wp", WPS)
def test_packing_and_stage_levels(Wp, layout):
    E, T, seg, threads, rpc = geometry(Wp, layout)
    assert E * T == Wp and threads % WARP == 0
    # every (row, lane) of the CTA once, a row's lanes aligned in one warp
    # when it has no more than 32
    tid = np.arange(threads)
    row, t = tid // T, tid & (T - 1)
    assert rpc * T == threads and sorted(zip(row, t)) == list(
        itertools.product(range(rpc), range(T)))
    if T <= WARP:
        assert np.all(tid // WARP == (tid - t) // WARP)
    else:   # the CTA's shared-memory row belongs to one row
        assert rpc == 1
    # the blocked and striped maps are bijections of the row's slots
    tt, ee = np.meshgrid(np.arange(T), np.arange(E), indexing="ij")
    assert np.array_equal(np.sort((tt * E + ee).ravel()), np.arange(Wp))
    assert np.array_equal(np.sort((ee * T + tt).ravel()), np.arange(Wp))
    # the loads read every slot once, neighbouring lanes neighbouring
    # addresses (16-byte groups only with E >= 16)
    for vec in (False, True) if E >= 16 else (False,):
        lm = load_map(T, E, vec)
        assert np.array_equal(np.sort(lm.ravel()), np.arange(Wp))
        assert np.all(np.diff(lm, axis=0) == (4 if vec else 1))
    counts = {"register": 0, "shuffle": 0, "shared": 0}
    for k, j in stages(Wp):
        lv = level(j, E)
        counts[lv] += 1
        pos = tt * E + ee
        if lv == "register":
            continue
        d = j // E
        partner = tt ^ d
        # the partner holds the partner slot in the same register
        assert np.array_equal(partner * E + ee, pos ^ j)
        if lv == "shuffle":
            # inside the warp and inside the row's segment of lanes
            assert d < seg and np.all(partner // seg == tt // seg)
        else:
            assert T > WARP and np.all(partner // WARP != tt // WARP)
            # a warp's 64-bit accesses cover 256 contiguous bytes: two
            # wavefronts, no bank conflict
            for e in range(E):
                for w in range(T // WARP):
                    lanes = np.arange(w * WARP, (w + 1) * WARP)
                    for idx in (e * T + lanes, e * T + (lanes ^ d)):
                        assert np.array_equal(np.sort(idx),
                                              np.arange(idx.min(),
                                                        idx.min() + WARP))
    L = Wp.bit_length() - 1
    le = E.bit_length() - 1
    assert sum(counts.values()) == L * (L + 1) // 2
    assert counts["register"] == le * (le + 1) // 2 + (L - le) * le
    assert counts["shared"] == (0 if T <= WARP else
                                sum(q - (le + 5) for q in range(le + 6,
                                                                 L + 1)))
    # 16-byte accesses (W % 16 == 0 and E >= 16, else scalar ones): each
    # 4-slot group loaded or stored is wholly inside or wholly past the
    # row, and the rows' offsets keep every vector access aligned
    if E < 16:
        return
    for W in range(Wp // 2 + 1, Wp + 1):
        if W % 16:
            continue
        first = load_map(T, E, True)[:, ::4]
        assert np.all((first < W) == (first + 3 < W))
        assert np.all(first % 4 == 0)
        n = W - np.arange(T) * E                   # the blocked stores
        for g in range(0, E, 4):
            assert np.all((g < n) == (g + 3 < n))
        assert (W * 4) % 16 == 0 and (E * 4) % 16 == 0


def cas(a, b, asc):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return np.where(asc, lo, hi), np.where(asc, hi, lo)


def lane_merge(x, E, asc):
    j = E // 2
    while j:
        lo = [e for e in range(E) if not e & j]
        hi = [e | j for e in lo]
        x[:, :, lo], x[:, :, hi] = cas(x[:, :, lo], x[:, :, hi], asc)
        j //= 2


def network(keys, lay, vec=False):
    """The kernel's loads and network on (R, Wp) uint64 keys; returns
    (R, T, E) in the blocked layout, and the levels its stages ran at."""
    R, Wp = keys.shape
    E, T, seg, _, _ = geometry(Wp, lay)
    x = keys[:, load_map(T, E, vec)]
    t = np.arange(T)
    ran = []
    k = 2
    while k < E:                       # blocks of k < E slots
        j = k // 2
        while j:
            lo = [e for e in range(E) if not e & j]
            hi = [e | j for e in lo]
            asc = (np.array(lo) & k) == 0
            x[:, :, lo], x[:, :, hi] = cas(x[:, :, lo], x[:, :, hi], asc)
            ran.append("register")
            j //= 2
        k *= 2
    lane_merge(x, E, (((t * E) & E) == 0)[None, :, None])
    ran += ["register"] * (E.bit_length() - 1)
    k = 2 * E
    while k <= Wp:
        asc = ((t * E) & k) == 0
        j = k // 2
        while j >= E:
            d = j // E
            take_max = (((t & d) != 0) == asc)[None, :, None]
            if d < WARP:               # __shfl_xor_sync
                y = x[:, t ^ d, :]
                ran.append("shuffle")
            else:                      # through the striped smem row
                smem = np.empty((R, Wp), np.uint64)
                ee = np.arange(E)
                smem[:, ee[None, :] * T + t[:, None]] = x
                y = smem[:, ee[None, :] * T + (t ^ d)[:, None]]
                ran.append("shared")
            x = np.where(take_max, np.maximum(x, y), np.minimum(x, y))
            j //= 2
        lane_merge(x, E, asc[None, :, None])
        ran += ["register"] * (E.bit_length() - 1)
        k *= 2
    return x, ran


@pytest.mark.parametrize("Wp", WPS)
def test_network_sorts_zero_one_rows(Wp, layout):
    rng = np.random.default_rng(Wp)
    if Wp <= 16:                       # every 0/1 row
        rows = np.array(list(itertools.product((0, 1), repeat=Wp)))
    else:                              # random densities, and the k-ones
        R = max(8, 4096 // Wp)         # prefixes and suffixes
        rows = (rng.random((R, Wp)) < rng.random((R, 1))).astype(np.int64)
        ks = rng.integers(0, Wp + 1, 4)
        ar = np.arange(Wp)
        rows = np.vstack([rows] + [(ar < k)[None].astype(np.int64)
                                   for k in ks]
                         + [(ar >= k)[None].astype(np.int64) for k in ks])
    x, ran = network(rows.astype(np.uint64), layout)
    E = geometry(Wp, layout)[0]
    assert [level(j, E) for _, j in stages(Wp)] == ran
    assert np.array_equal(x.reshape(rows.shape),
                          np.sort(rows, axis=1).astype(np.uint64))


@pytest.mark.parametrize("Wp", WPS)
def test_network_sorts_random_rows(Wp, layout):
    rng = np.random.default_rng(100 + Wp)
    R = max(4, 8192 // Wp)
    keys = rng.integers(0, 1 << 63, (R, Wp), dtype=np.uint64)
    keys[:, ::3] = keys[:, :1]                   # duplicates
    keys[rng.random((R, Wp)) < 0.2] = PAD        # padding keys
    for vec in (False, True) if geometry(Wp, layout)[0] >= 16 else (False,):
        x, _ = network(keys, layout, vec)
        assert np.array_equal(x.reshape(R, Wp), np.sort(keys, axis=1))


def add_mod(a, b, p):
    s = a + b
    s = np.where(s > p // 2, s - p, s)
    return np.where(s < -(p // 2), s + p, s)


def shfl_up(v, d, seg):
    """__shfl_up_sync(kFull, v, d, seg) over the lanes (last axis) of
    every row: lane t reads lane t - d of its segment, else its own."""
    t = np.arange(v.shape[-1])
    return v[..., np.where((t & (seg - 1)) >= d, t - d, t)]


def shfl_down(v, d, seg):
    t = np.arange(v.shape[-1])
    return v[..., np.where((t & (seg - 1)) + d < seg, t + d, t)]


def kernel_model(f, cols, vals, m, lay):
    """merge_rows_kernel on an (R, W) tile: loads with padding, the
    network, the scan and the writes of the slots below W."""
    R, W = cols.shape
    Wp = 1 << (W - 1).bit_length()
    E, T, seg, _, _ = geometry(Wp, lay)
    p = f.p
    keys = np.full((R, Wp), PAD, np.uint64)
    keys[:, :W] = ((cols.astype(np.int64).astype(np.uint64) << np.uint64(32))
                   | (vals.astype(np.int64) & 0xFFFFFFFF).astype(np.uint64))
    x, _ = network(keys, lay, W % 16 == 0 and E >= 16)
    col = (x >> np.uint64(32)).astype(np.int64)
    col = np.where(col >= 1 << 31, col - (1 << 32), col)      # pad: -1
    val = (x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    val = np.where(val >= 1 << 31, val - (1 << 32), val)
    t = np.arange(T)
    lane = t & (WARP - 1)
    warp = t // WARP
    first, last = col[:, :, 0], col[:, :, E - 1]
    prevc = shfl_up(last, 1, seg)
    nextc = shfl_down(first, 1, seg)
    if T > WARP:                                 # the edge columns in smem
        edge0, edge1 = first[:, lane == 0], last[:, lane == 31]
        fix = (lane == 0) & (t > 0)
        prevc[:, fix] = edge1[:, warp[fix] - 1]
        fix = (lane == 31) & (t < T - 1)
        nextc[:, fix] = edge0[:, warp[fix] + 1]
    prevc[:, 0] = -1
    nextc[:, T - 1] = -1
    fl = np.zeros((R, T), bool)
    v = np.zeros((R, T), np.int64)
    pc = prevc
    for e in range(E):
        start = col[:, :, e] != pc
        v = np.where(start, val[:, :, e], add_mod(v, val[:, :, e], p))
        fl |= start
        pc = col[:, :, e]
    ts = t & (seg - 1)
    d = 1
    while d < seg:
        f2, v2 = shfl_up(fl, d, seg), shfl_up(v, d, seg)
        upd = ts >= d
        v = np.where(upd & ~fl, add_mod(v2, v, p), v)
        fl = np.where(upd, fl | f2, fl)
        d *= 2
    fe, run = shfl_up(fl, 1, seg), shfl_up(v, 1, seg)
    if T > WARP:                                 # the warps' carry
        wflag, wsum = fl[:, lane == 31], v[:, lane == 31]
        wv = np.zeros((R, T // WARP), np.int64)
        acc = np.zeros(R, np.int64)
        for u in range(1, T // WARP):
            acc = np.where(wflag[:, u - 1], wsum[:, u - 1],
                           add_mod(acc, wsum[:, u - 1], p))
            wv[:, u] = acc
        wv = wv[:, warp]
        run = np.where(ts == 0, wv, np.where(fe, run, add_mod(wv, run, p)))
    out_c = np.empty((R, T, E), np.int64)
    out_v = np.empty((R, T, E), np.int64)
    keep = np.empty((R, T, E), bool)
    pc = prevc
    for e in range(E):
        c = col[:, :, e]
        run = np.where(c != pc, val[:, :, e], add_mod(run, val[:, :, e], p))
        nc = col[:, :, e + 1] if e + 1 < E else nextc
        out_c[:, :, e], out_v[:, :, e] = c, run
        keep[:, :, e] = (nc != c) & (run != 0) & (c < m)
        pc = c
    return (out_c.reshape(R, Wp)[:, :W].astype(np.int32),
            out_v.reshape(R, Wp)[:, :W].astype(np.int32),
            keep.reshape(R, Wp)[:, :W])


def tile(f, R, W, m, rng):
    """Dead slots (col == m, val 0), frequent duplicates, an all-dead row,
    a row that cancels to zero and a single-run row."""
    cols = rng.integers(0, max(1, min(m, W // 2 + 2)), (R, W)).astype(np.int32)
    cols[rng.random((R, W)) < 0.3] = m
    vals = f.rand((R, W), rng).astype(np.int64)
    vals[cols == m] = 0
    cols[0], vals[0] = m, 0
    h = W // 2
    cols[1, h:2 * h] = cols[1, :h]
    vals[1, h:2 * h] = -vals[1, :h]
    cols[1, 2 * h:], vals[1, 2 * h:] = m, 0
    cols[2] = m // 2
    return cols, vals.astype(np.int32)


@pytest.mark.parametrize("W", [1, 2, 3, 31, 32, 33, 272, 511, 512, 513,
                               1024, 1025, 1040, 2049, 16384])
@pytest.mark.parametrize("p", [5, 42013, 4294967291])
def test_scan_matches_plain(W, p, layout):
    f = field(p)
    rng = np.random.default_rng(W * 7 + p % 1000)
    R, m = max(4, 8192 // W), max(3, W // 3)
    cols, vals = tile(f, R, W, m, rng)
    got = kernel_model(f, cols, vals, m, layout)
    want = merge_rows_plain(f, torch.from_numpy(cols),
                            torch.from_numpy(vals), m)
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())
