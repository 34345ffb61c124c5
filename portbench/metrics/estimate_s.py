"""estimate_s: the program's span ``estimate`` (``last_phase_stats()``): each
round's Schur density estimate, dense-switch test and fill filter, mean
over the window's calls."""


def read(record):
    vals = [s["estimate_s"] for s in record["phase_stats"]
            if "estimate_s" in s]
    return sum(vals) / len(vals) if vals else None
