"""A dense finish whose panel groups are mostly dead, for the tests of the
RREF's skipped groups (no jax here: the card's tests import it too).

``dead_group_matrix`` gives 5 blocks of ``bs`` rows over three groups of
``gw`` columns (the last one ``last`` wide), so that each block's RREF
(panel groups of ``gw`` columns, bs <= gw) runs the bodies below and no
other, 3 of 15:

* block 0: a random full-rank block on group 1 alone: group 0 is all
  zero, group 1 finds bs pivots and the exit falls before group 2;
* block 1: all zero, a dry block: no body runs;
* block 2: combinations of block 0's rows plus random entries on group 2:
  eliminated against block 0's pivots, only the last group is live;
* block 3: multiples of block 0's rows, dry once eliminated;
* block 4: random on every column: group 0 finds bs pivots and the exit
  falls in the middle of the block.
"""

import numpy as np

RUNS = 3          # the bodies the five blocks run, of 5 * 3 groups
GROUPS = 3


def dead_group_matrix(f, seed: int, bs: int, gw: int, last: int):
    rng = np.random.default_rng(seed)
    m = 2 * gw + last
    X = np.zeros((5 * bs, m), np.int64)
    X[:bs, gw:2 * gw] = f.rand((bs, gw), rng)
    # small coefficients: the products stay far inside int64
    X[2 * bs:3 * bs] = f.normalize(rng.integers(-2, 3, (bs, bs)) @ X[:bs])
    X[2 * bs:3 * bs, 2 * gw:] = f.rand((bs, last), rng)
    X[3 * bs:4 * bs] = f.normalize(X[:bs] * 3)
    X[4 * bs:] = f.rand((bs, m), rng)
    return X
