"""finish_copy_mb: the megabytes (1e6 bytes) the dense finish copied
between the host and the card (``last_phase_stats()``'s
finish_copy_bytes: S's CSR uploaded, the block pivots and U's CSR read
back), mean over the window's calls; nothing where the program keeps no
such count."""


def read(record):
    vals = [s["finish_copy_bytes"] for s in record["phase_stats"]
            if "finish_copy_bytes" in s]
    return sum(vals) / len(vals) / 1e6 if vals else None
