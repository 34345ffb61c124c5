"""echelonize_s: the window's seconds over its completed calls."""


def read(record):
    return record["window_s"] / record["calls"]
