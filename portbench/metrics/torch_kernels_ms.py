"""torch_kernels_ms: device milliseconds a traced call of PyTorch's own
kernels (names in ``at::`` or ``cub::``), which the blocked Jordan RREF
launches around K1 and K2."""

import trace_read

NAMES = ("at::", "cub::")


def read(record):
    tr = record["trace"]
    s = trace_read.kernel_seconds(tr, NAMES) if tr else 0.0
    return s / tr["calls"] * 1e3 if s else None
