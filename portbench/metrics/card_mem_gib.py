"""card_mem_gib: the most device memory the process held (reserved by
PyTorch's allocator, graph pools included), set-up and window, in GiB."""


def read(record):
    peak = record["memory_reserved_peak"]
    return peak / 2**30 if peak else None
