from swtpu_torch.core.scoring import (  # noqa: F401
    DNA_10_30_15,
    DNA_111,
    ScoringParams,
    dna_matrix,
    scoring_from_numpy,
)
from swtpu_torch.core.encode import (  # noqa: F401
    mutate,
    pack_2bit,
    random_dna,
    unpack_2bit,
)
from swtpu_torch.core.cigar import path_to_cigar, cigar_stats  # noqa: F401
