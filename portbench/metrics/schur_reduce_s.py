"""schur_reduce_s: the program's span ``schur.reduce`` (``last_phase_stats()``):
each round's mutual reduction of its pivot block, mean over the window's
calls; nothing where the program has no such span."""


def read(record):
    vals = [s["schur_reduce_s"] for s in record["phase_stats"]
            if "schur_reduce_s" in s]
    return sum(vals) / len(vals) if vals else None
