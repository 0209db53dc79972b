"""Long pairs on one card (``longpair``): the one-device sweep of a
single huge DP matrix in tiles. The mesh (``data_parallel_scores``, the
sharded sweeps) and search are later slices (ROADMAP.md queue A items
12b and 7)."""

from swtpu_torch.parallel.longpair import (  # noqa: F401
    longpair_sw_align,
    longpair_sw_ends,
    longpair_sw_score,
)
