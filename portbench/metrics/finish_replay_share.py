"""finish_replay_share: the share of the window's calls whose dense
finish replayed a cached CUDA graph (``ops/dense.last_finish``)."""


def read(record):
    graphs = [g for g in record["finish_graph"] if g is not None]
    if not graphs:
        return None
    return sum(g == "replayed" for g in graphs) / len(record["finish_graph"])
