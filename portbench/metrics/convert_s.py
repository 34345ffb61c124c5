"""convert_s: the program's span ``convert`` (``last_phase_stats()``):
the matrix's conversions to and from SciPy at the call's and each round's
start, mean over the window's calls."""


def read(record):
    vals = [s["convert_s"] for s in record["phase_stats"]
            if "convert_s" in s]
    return sum(vals) / len(vals) if vals else None
