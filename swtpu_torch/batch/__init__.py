from swtpu_torch.batch.bucketing import (  # noqa: F401
    bucket_edges,
    sw_scores_bucketed,
    sw_scores_varlen,
)
from swtpu_torch.batch.promote import sw_scores_promoted  # noqa: F401
from swtpu_torch.batch.traceback import (  # noqa: F401
    nw_align_batch,
    semiglobal_align_batch,
    sw_align_batch,
)
