"""setup_s: seconds from the process's start to the end of the warm-up
calls: imports, the kernels' build or load, the pool, and the warm calls."""


def read(record):
    return record["setup_s"]
