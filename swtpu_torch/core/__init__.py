from swtpu_torch.core.scoring import (  # noqa: F401
    DNA_10_30_15,
    DNA_111,
    ScoringParams,
    dna_matrix,
    scoring_from_numpy,
)
