"""Long pairs on one card (``longpair``: the one-device sweep of a single
huge DP matrix in tiles) and all-vs-all database search on one card
(``search``). The mesh (``data_parallel_scores``, the sharded sweeps and
the sharded search) is a later slice (ROADMAP.md queue A item 12b)."""

from swtpu_torch.parallel.longpair import (  # noqa: F401
    longpair_sw_align,
    longpair_sw_ends,
    longpair_sw_score,
)
from swtpu_torch.parallel.search import (  # noqa: F401
    SearchCheckpoint,
    all_vs_all_topk,
)
