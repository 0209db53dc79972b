from swtpu_torch.oracle.sw import (  # noqa: F401
    sw_score,
    sw_score_batch,
    sw_traceback,
)
from swtpu_torch.oracle.affine import (  # noqa: F401
    sw_affine_score,
    sw_affine_traceback,
)
