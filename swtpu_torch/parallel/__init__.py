"""Long pairs (``longpair``: one huge DP matrix swept in tiles, its query
strips over a mesh), all-vs-all database search (``search``, on one card
or sharded over a mesh) and the mesh itself (``mesh``: a 1-D
``torch.distributed`` ``DeviceMesh``, data-parallel scores)."""

from swtpu_torch.parallel.longpair import (  # noqa: F401
    longpair_sw_align,
    longpair_sw_ends,
    longpair_sw_score,
)
from swtpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_scores,
    init_distributed,
    make_mesh,
    shard_batch,
)
from swtpu_torch.parallel.search import (  # noqa: F401
    SearchCheckpoint,
    all_vs_all_topk,
    sharded_all_vs_all_topk,
)
