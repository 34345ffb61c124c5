"""k2_ms: device milliseconds a traced call of K2, the program's panel
kernel (the name of ``chip_smoke.OWN_KERNELS``)."""

import trace_read

NAMES = ("panel_cluster_kernel",)


def read(record):
    tr = record["trace"]
    s = trace_read.kernel_seconds(tr, NAMES) if tr else 0.0
    return s / tr["calls"] * 1e3 if s else None
