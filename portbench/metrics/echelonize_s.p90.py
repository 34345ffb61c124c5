"""echelonize_s.p90: the 90th percentile of the window's call walls
(nothing below ten calls)."""

import statistics


def read(record):
    walls = record["walls"]
    if len(walls) < 10:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
