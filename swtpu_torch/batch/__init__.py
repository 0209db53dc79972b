from swtpu_torch.batch.bucketing import (  # noqa: F401
    bucket_edges,
    sw_scores_bucketed,
    sw_scores_varlen,
)
from swtpu_torch.batch.promote import sw_scores_promoted  # noqa: F401
from swtpu_torch.batch.traceback import (  # noqa: F401
    banded_affine_traceback,
    banded_align_batch,
    banded_forward_batch,
    banded_static_align_batch,
    banded_traceback,
    banded_walk_batch,
    nw_align_batch,
    reconstruct_affine_bands,
    semiglobal_align_batch,
    sw_align_batch,
)
