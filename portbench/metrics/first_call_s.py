"""first_call_s: the wall of the process's first echelonize, made in
set-up once the card's context, the kernels and the pool exist."""


def read(record):
    return record["first_call_s"]
