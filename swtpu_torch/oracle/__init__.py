from swtpu_torch.oracle.sw import (  # noqa: F401
    sw_score,
    sw_score_batch,
    sw_traceback,
)
from swtpu_torch.oracle.affine import (  # noqa: F401
    sw_affine_score,
    sw_affine_score_batch,
    sw_affine_traceback,
)
from swtpu_torch.oracle.semiglobal import (  # noqa: F401
    banded_xdrop,
    nw_affine_full,
    nw_full,
    semiglobal_affine_full,
    semiglobal_full,
)
from swtpu_torch.oracle.banded_affine import banded_affine_xdrop  # noqa: F401
from swtpu_torch.oracle.banded_static import (  # noqa: F401
    sw_banded_static_score,
    sw_banded_static_score_batch,
    sw_banded_static_traceback,
)
from swtpu_torch.oracle.banded_block import (  # noqa: F401
    BandedBlockResult,
    banded_xdrop_block,
    banded_xdrop_block_affine,
    reconstruct_block_ef,
    walk_block_history,
    walk_block_history_affine,
)
