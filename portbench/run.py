"""The benchmark of spasm_tpu_torch: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Set-up builds or loads the program's
kernels, makes the cell's pool of matrices from ``--seed`` and warms the
program up; the window then calls ``spasm_tpu_torch.echelonize`` on the
pool's matrices in turn, one call at a time, for ``--seconds`` seconds.
The plain reference (``reference.py``) then judges every output.  The last
line of standard output is the result, as JSON; the last lines of standard
error are the numbers compared, each with its limit.  Without a card, or
with fewer cards than the cell asks for, it prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel caches stay inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    sys.path[:0] = [HERE, ROOT]
    import harness
    import torch

    files = harness.cell(args.workload)
    chips = int(files["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1

    import spasm_tpu_torch as program
    from spasm_tpu_torch._host.utils.hostmem import tune_host_malloc
    from spasm_tpu_torch.ops import _cuda

    tune_host_malloc()          # as the program's CLI does
    torch.zeros(1, device="cuda")
    t_ctx = time.perf_counter()
    _cuda.lib()                 # build once per checkout, then load
    print(f"setup: imports and context {t_ctx - T_START:.3f} s, kernels "
          f"{time.perf_counter() - t_ctx:.3f} s (nvcc "
          f"{_cuda.build_seconds or 0.0:.1f} s)", file=sys.stderr)

    result = harness.run(args, device="cuda", program=program,
                         sync=torch.cuda.synchronize, t_start=T_START,
                         cell_files=files)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port may not load: "
              f"{bad}", file=sys.stderr)
        return 1
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
