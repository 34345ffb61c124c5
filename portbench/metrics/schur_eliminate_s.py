"""schur_eliminate_s: the program's span ``schur.eliminate``
(``last_phase_stats()``): each round's Schur update of the remaining rows
against its pivot block, mean over the window's calls; nothing where the
program has no such span."""


def read(record):
    vals = [s["schur_eliminate_s"] for s in record["phase_stats"]
            if "schur_eliminate_s" in s]
    return sum(vals) / len(vals) if vals else None
