"""assemble_s: the program's span ``assemble`` (``last_phase_stats()``): U,
qinv and L put together after the finish, mean over the window's calls."""


def read(record):
    vals = [s["assemble_s"] for s in record["phase_stats"]
            if "assemble_s" in s]
    return sum(vals) / len(vals) if vals else None
