"""finish_wait_s: the program's span ``finish.wait`` (``last_phase_stats()``):
the dense finish's uploads and block loop up to the return of its first
readback, mean over the window's calls."""


def read(record):
    vals = [s["finish_wait_s"] for s in record["phase_stats"]
            if "finish_wait_s" in s]
    return sum(vals) / len(vals) if vals else None
