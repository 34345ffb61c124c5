"""unspanned_s: the part of a call's wall that none of the program's
top-level spans names (``last_phase_stats()``: convert, pivots, estimate,
schur, finish, assemble), mean over the window's calls that report all
six."""

TOP = ("convert_s", "pivot_s", "estimate_s", "schur_s", "finish_s",
       "assemble_s")


def read(record):
    vals = [w - sum(s[k] for k in TOP)
            for w, s in zip(record["walls"], record["phase_stats"])
            if all(k in s for k in TOP)]
    return sum(vals) / len(vals) if vals else None
