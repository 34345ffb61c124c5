"""finish_tail_s: the program's span ``finish.tail`` (``last_phase_stats()``):
the dense finish's checks of whether its unprocessed rows lie in the row
space found so far, mean over the window's calls; nothing where the program
has no such span."""


def read(record):
    vals = [s["finish_tail_s"] for s in record["phase_stats"]
            if "finish_tail_s" in s]
    return sum(vals) / len(vals) if vals else None
