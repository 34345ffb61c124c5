"""The control of ``correct``: the plain reference put in the program's
place, its echelon forms computed with float32 products, and judged by
the harness's own comparison.  It has to come out as not correct, or the
comparison could not tell a lost guarantee of exactness from an exact
answer.

    python3 portbench/control.py --workload <name> --seeds 1 2 3

For each seed it builds the cell's pool on the card as a run does, puts
``reference.echelon_form(..., arith="float32")`` of every matrix in the
place of the program's outputs, runs ``harness.check`` on them and prints
one JSON line: the control's ranks, the numbers compared with their
limits, and ``correct``.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def verdict(files: dict, seed: int, device, arith: str = "float32") -> dict:
    """The harness's verdict on the pool of ``seed`` with the reference's
    echelon forms (``arith``) as the outputs."""
    import harness
    import reference

    seeds = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(2)
    pool = files["gen"].make_pool(files["config"], files["traffic"],
                                  np.random.default_rng(seeds[0]), device)
    t = time.perf_counter()
    outs = [(k, reference.echelon_form(A, pool["p"], device, arith=arith))
            for k, A in enumerate(pool["matrices"])]
    form_s = time.perf_counter() - t
    checks, failed, _ = harness.check(pool, outs, device,
                                      np.random.default_rng(seeds[1]))
    return {"seed": seed, "arith": arith,
            "ranks": [o["r"] for _, o in outs], "form_s": form_s,
            "failed": failed, "attempted": len(outs), "checks": checks,
            "correct": harness.verdict(checks, failed, len(outs))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    import torch

    import harness

    if not torch.cuda.is_available():
        print("portbench: the control runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    files = harness.cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(verdict(files, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
