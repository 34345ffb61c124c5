"""finish_extract_s: the program's span ``finish.extract``
(``last_phase_stats()``): the dense finish's pivot lists, U's extraction
(the second readback) and its host CSR, mean over the window's calls."""


def read(record):
    vals = [s["finish_extract_s"] for s in record["phase_stats"]
            if "finish_extract_s" in s]
    return sum(vals) / len(vals) if vals else None
