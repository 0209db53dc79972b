"""The models: seed-and-extend read mapping (``mapper``), center-star MSA
(``msa``) and greedy overlap-layout-consensus assembly (``assembly``).
Port of ``swtpu/models``; the mapper's entry points are exported here too."""

from swtpu_torch.models.assembly import assemble_greedy, make_reads  # noqa: F401
from swtpu_torch.models.mapper import (  # noqa: F401
    build_index,
    extend_candidates,
    find_candidates,
    map_reads,
    map_reads_pipelined,
)
from swtpu_torch.models.msa import (  # noqa: F401
    msa_center_star,
    msa_rows_to_strings,
    sp_score,
)
