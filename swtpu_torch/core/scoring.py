"""Scoring model: substitution matrix + gap penalties.

Port of ``swtpu/core/scoring.py``. The scoring system is host-side state
(a small integer matrix and two penalties), so it stays a frozen
dataclass over a numpy matrix; kernels receive its scalars, the plain
tiers an int32 table built from it on their device.

Linear gap is the ``gap_open == gap_extend`` special case. Opening a gap
of length L costs ``gap_open + (L - 1) * gap_extend``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Alignment scoring parameters.

    Attributes:
      matrix: [A, A] int substitution scores (A = alphabet size; 4 for DNA).
      gap_open: penalty (positive) for opening a gap.
      gap_extend: penalty (positive) for extending a gap by one.
    """

    matrix: np.ndarray
    gap_open: int
    gap_extend: int

    def __post_init__(self):
        m = np.asarray(self.matrix, dtype=np.int32)
        if m.ndim != 2 or m.shape[0] != m.shape[1]:
            raise ValueError(f"matrix must be square, got {m.shape}")
        object.__setattr__(self, "matrix", m)
        object.__setattr__(self, "gap_open", int(self.gap_open))
        object.__setattr__(self, "gap_extend", int(self.gap_extend))

    @property
    def alphabet_size(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def is_linear(self) -> bool:
        return self.gap_open == self.gap_extend

    @property
    def gap(self) -> int:
        """Linear gap penalty (valid only when is_linear)."""
        if not self.is_linear:
            raise ValueError("gap requested on affine ScoringParams")
        return self.gap_open

    @staticmethod
    def linear(matrix: np.ndarray, gap: int) -> "ScoringParams":
        return ScoringParams(matrix=matrix, gap_open=gap, gap_extend=gap)


def scoring_from_numpy(matrix, gap_open: int, gap_extend: int) -> ScoringParams:
    """Build the port's ScoringParams from a plain matrix and two ints.

    This is how a scoring system crosses from the JAX package (its
    ``ScoringParams.matrix`` is a numpy array) into the port: only numpy
    data and Python ints cross, never an object of the other package.
    """
    return ScoringParams(
        matrix=np.array(matrix, dtype=np.int32, copy=True),
        gap_open=int(gap_open),
        gap_extend=int(gap_extend),
    )


def dna_matrix(match: int, mismatch: int) -> np.ndarray:
    """4x4 DNA substitution matrix with uniform match/mismatch scores."""
    m = np.full((4, 4), int(mismatch), dtype=np.int32)
    np.fill_diagonal(m, int(match))
    return m


#: The reference's general-scoring test parameters: match +10,
#: mismatch -30, linear gap 15 (the SpeedTest scoring).
DNA_10_30_15 = ScoringParams.linear(dna_matrix(10, -30), 15)

#: The reference's fixed "(1,1,1)" scoring: match +1, mismatch -1, gap 1.
DNA_111 = ScoringParams.linear(dna_matrix(1, -1), 1)
