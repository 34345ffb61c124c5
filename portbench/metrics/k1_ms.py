"""k1_ms: device milliseconds a traced call of K1, the program's split
and product kernels (the names of ``chip_smoke.OWN_KERNELS``)."""

import trace_read

NAMES = ("modmatmul_kernel", "split_rows_kernel", "split_transpose_kernel")


def read(record):
    tr = record["trace"]
    s = trace_read.kernel_seconds(tr, NAMES) if tr else 0.0
    return s / tr["calls"] * 1e3 if s else None
