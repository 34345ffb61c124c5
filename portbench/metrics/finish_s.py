"""finish_s: the program's own wall of that phase (``last_phase_stats()``),
mean over the window's calls."""


def read(record):
    vals = [s["finish_s"] for s in record["phase_stats"] if "finish_s" in s]
    return sum(vals) / len(vals) if vals else None
