"""stream_block_ms: milliseconds a row block of the dense finish's streaming
loop, its tail checks left out: the window's ``finish_wait_s`` less
``finish_tail_s`` over its ``finish_blocks`` (``last_phase_stats()``), summed
over the calls that took the streaming loop; nothing where none did or the
program keeps no such counts."""


def read(record):
    calls = [s for s in record["phase_stats"]
             if s.get("finish_blocks", 0) > 0 and "finish_tail_s" in s]
    blocks = sum(s["finish_blocks"] for s in calls)
    if not blocks:
        return None
    return 1000.0 * sum(s["finish_wait_s"] - s["finish_tail_s"]
                        for s in calls) / blocks
