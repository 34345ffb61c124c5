"""Random sparse matrices over GF(p) with planted dependent rows.

The family of SpaSM.jl's ``sprand`` (src/SpaSM.jl:445), which the
program's ``SparseGFp.rand`` follows: an iid Bernoulli(density) pattern
with uniform nonzero values, balanced.  Each draw is made on the run's
device from a ``torch.Generator`` seeded from the pool's seed, in a few
whole-matrix calls, and handed to both sides as a SciPy CSR matrix.

Each draw then has its last ``planted_rows`` rows replaced by random
combinations of ``PLANTED_TERMS`` other rows.  A random matrix has full
rank with probability near 1, and a full-rank square matrix has the
identity as its reduced echelon form, so no arithmetic fault and no loss
of exactness could show in it; the planted rows make the rank a question
(n - planted_rows) and give the echelon form free columns whose values the
comparison checks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

PLANTED_TERMS = 3


def draw(p: int, n: int, m: int, density: float, planted: int, seed: int,
         device) -> sp.csr_matrix:
    """One draw: the iid pattern, uniform values in [1, p), the last
    ``planted`` rows replaced by combinations of ``PLANTED_TERMS`` distinct
    rows among the others with uniform nonzero coefficients; balanced CSR
    with sorted indices and no explicit zeros."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    nz = (torch.rand((n, m), generator=g, device=device) < density).nonzero()
    X = torch.zeros((n, m), dtype=torch.int64, device=device)
    X[nz[:, 0], nz[:, 1]] = torch.randint(1, p, (nz.shape[0],), generator=g,
                                          device=device)
    del nz
    if planted:
        keep = n - planted
        src = torch.rand((planted, keep), generator=g,
                         device=device).argsort(dim=1)[:, :PLANTED_TERMS]
        coef = torch.randint(1, p, (planted, PLANTED_TERMS), generator=g,
                             device=device)
        rows = torch.zeros((planted, m), dtype=torch.int64, device=device)
        # one term at a time keeps every product below 2**62
        for t in range(PLANTED_TERMS):
            rows = torch.remainder(rows + coef[:, t:t + 1] * X[src[:, t]], p)
        X[keep:] = rows
    X = torch.where(X > p // 2, X - p, X)
    nz = X.nonzero()
    data = X[nz[:, 0], nz[:, 1]].cpu().numpy()
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(torch.bincount(nz[:, 0], minlength=n).cpu().numpy(),
              out=indptr[1:])
    return sp.csr_matrix((data, nz[:, 1].cpu().numpy(), indptr),
                         shape=(n, m))


def make_pool(config: dict, traffic: dict, rng: np.random.Generator,
              device) -> dict:
    """``traffic['pool']`` independent draws, each from a seed of its own
    drawn from ``rng``.  Each draw is its own base: the reference works
    out every rank."""
    p = int(traffic["p"])
    seeds = rng.integers(0, 2**63 - 1, size=traffic["pool"])
    mats = [draw(p, config["n"], config["m"], config["density"],
                 traffic["planted_rows"], s, device) for s in seeds]
    return {"p": p, "matrices": mats, "bases": mats,
            "base_of": list(range(len(mats)))}
