"""finish_skip_share: the share of the dense finish's rows that its tail
check certified as lying in the row space already found, so that no block
eliminated them (``last_phase_stats()``: ``finish_rows_skipped`` over
``finish_rows``, summed over the window's calls); nothing where no call had
a dense finish or the program keeps no such counts."""


def read(record):
    calls = [s for s in record["phase_stats"]
             if "finish_rows_skipped" in s and "finish_rows" in s]
    rows = sum(s["finish_rows"] for s in calls)
    return sum(s["finish_rows_skipped"] for s in calls) / rows if rows else None
