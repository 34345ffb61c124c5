"""pivot_s: the program's own wall of that phase (``last_phase_stats()``),
mean over the window's calls."""


def read(record):
    vals = [s["pivot_s"] for s in record["phase_stats"] if "pivot_s" in s]
    return sum(vals) / len(vals) if vals else None
