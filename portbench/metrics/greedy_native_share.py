"""greedy_native_share: the share of the window's structural pivot
searches whose greedy completion ran in C, of all whose completion ran
(``last_phase_stats()``: greedy_native over greedy_native + greedy_numpy,
summed over the window's calls); nothing where no completion ran or the
program keeps no such counts."""


def read(record):
    native = sum(s.get("greedy_native", 0) for s in record["phase_stats"])
    ran = native + sum(s.get("greedy_numpy", 0)
                       for s in record["phase_stats"])
    return native / ran if ran else None
