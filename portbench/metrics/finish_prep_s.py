"""finish_prep_s: the program's span ``finish.prep`` (``last_phase_stats()``):
the finish's host work before its first upload (alive columns, density
gate, COO build and sort), mean over the window's calls."""


def read(record):
    vals = [s["finish_prep_s"] for s in record["phase_stats"]
            if "finish_prep_s" in s]
    return sum(vals) / len(vals) if vals else None
