"""Scale-out over ``torch.distributed``: one process a rank (SPMD), a 1-D
device mesh over the ranks (``multihost``), the distributed dense rounds
(``sharded``) and the pivot elections (``sparse_sharded``)."""
