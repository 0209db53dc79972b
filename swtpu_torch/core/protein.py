"""Protein alphabet + BLOSUM62 scoring (BASELINE config 3).

Copy of ``swtpu/core/protein.py`` (numpy only), kept in the port so that
it imports nothing of the JAX package; ``blosum62_params`` builds the
port's own ScoringParams.

The reference is DNA-only (4-letter, 4x4 matrix, source.cpp:35-39); protein
support is a mandated extension. Alphabet: the standard NCBI 24-letter
order ARNDCQEGHILKMFPSTWYVBZX* (20 amino acids + ambiguity codes B, Z, X
and stop *), encoded 0..23. Pad codes continue the scheme used by the DNA
engines: query pad = 24, target pad = 25.
"""

from __future__ import annotations

import numpy as np

from swtpu_torch.core.scoring import ScoringParams

#: Residue order of the standard NCBI BLOSUM62 table.
PROTEIN_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"

PROTEIN_Q_PAD = 24
PROTEIN_T_PAD = 25

#: Standard NCBI BLOSUM62 substitution matrix, 24x24, row/col order
#: PROTEIN_ALPHABET.
BLOSUM62 = np.array(
    [
        # A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  Z  X  *
        [ 4,-1,-2,-2, 0,-1,-1, 0,-2,-1,-1,-1,-1,-2,-1, 1, 0,-3,-2, 0,-2,-1, 0,-4],  # A
        [-1, 5, 0,-2,-3, 1, 0,-2, 0,-3,-2, 2,-1,-3,-2,-1,-1,-3,-2,-3,-1, 0,-1,-4],  # R
        [-2, 0, 6, 1,-3, 0, 0, 0, 1,-3,-3, 0,-2,-3,-2, 1, 0,-4,-2,-3, 3, 0,-1,-4],  # N
        [-2,-2, 1, 6,-3, 0, 2,-1,-1,-3,-4,-1,-3,-3,-1, 0,-1,-4,-3,-3, 4, 1,-1,-4],  # D
        [ 0,-3,-3,-3, 9,-3,-4,-3,-3,-1,-1,-3,-1,-2,-3,-1,-1,-2,-2,-1,-3,-3,-2,-4],  # C
        [-1, 1, 0, 0,-3, 5, 2,-2, 0,-3,-2, 1, 0,-3,-1, 0,-1,-2,-1,-2, 0, 3,-1,-4],  # Q
        [-1, 0, 0, 2,-4, 2, 5,-2, 0,-3,-3, 1,-2,-3,-1, 0,-1,-3,-2,-2, 1, 4,-1,-4],  # E
        [ 0,-2, 0,-1,-3,-2,-2, 6,-2,-4,-4,-2,-3,-3,-2, 0,-2,-2,-3,-3,-1,-2,-1,-4],  # G
        [-2, 0, 1,-1,-3, 0, 0,-2, 8,-3,-3,-1,-2,-1,-2,-1,-2,-2, 2,-3, 0, 0,-1,-4],  # H
        [-1,-3,-3,-3,-1,-3,-3,-4,-3, 4, 2,-3, 1, 0,-3,-2,-1,-3,-1, 3,-3,-3,-1,-4],  # I
        [-1,-2,-3,-4,-1,-2,-3,-4,-3, 2, 4,-2, 2, 0,-3,-2,-1,-2,-1, 1,-4,-3,-1,-4],  # L
        [-1, 2, 0,-1,-3, 1, 1,-2,-1,-3,-2, 5,-1,-3,-1, 0,-1,-3,-2,-2, 0, 1,-1,-4],  # K
        [-1,-1,-2,-3,-1, 0,-2,-3,-2, 1, 2,-1, 5, 0,-2,-1,-1,-1,-1, 1,-3,-1,-1,-4],  # M
        [-2,-3,-3,-3,-2,-3,-3,-3,-1, 0, 0,-3, 0, 6,-4,-2,-2, 1, 3,-1,-3,-3,-1,-4],  # F
        [-1,-2,-2,-1,-3,-1,-1,-2,-2,-3,-3,-1,-2,-4, 7,-1,-1,-4,-3,-2,-2,-1,-2,-4],  # P
        [ 1,-1, 1, 0,-1, 0, 0, 0,-1,-2,-2, 0,-1,-2,-1, 4, 1,-3,-2,-2, 0, 0, 0,-4],  # S
        [ 0,-1, 0,-1,-1,-1,-1,-2,-2,-1,-1,-1,-1,-2,-1, 1, 5,-2,-2, 0,-1,-1, 0,-4],  # T
        [-3,-3,-4,-4,-2,-2,-3,-2,-2,-3,-2,-3,-1, 1,-4,-3,-2,11, 2,-3,-4,-3,-2,-4],  # W
        [-2,-2,-2,-3,-2,-1,-2,-3, 2,-1,-1,-2,-1, 3,-3,-2,-2, 2, 7,-1,-3,-2,-1,-4],  # Y
        [ 0,-3,-3,-3,-1,-2,-2,-3,-3, 3, 1,-2, 1,-1,-2,-2, 0,-3,-1, 4,-3,-2,-1,-4],  # V
        [-2,-1, 3, 4,-3, 0, 1,-1, 0,-3,-4, 0,-3,-3,-2, 0,-1,-4,-3,-3, 4, 1,-1,-4],  # B
        [-1, 0, 0, 1,-3, 3, 4,-2, 0,-3,-3, 1,-1,-3,-1, 0,-1,-3,-2,-2, 1, 4,-1,-4],  # Z
        [ 0,-1,-1,-1,-2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-2, 0, 0,-2,-1,-1,-1,-1,-1,-4],  # X
        [-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4, 1],  # *
    ],
    dtype=np.int32,
)


def encode_protein(seq: str) -> np.ndarray:
    """Encode an amino-acid string into 0..23 codes."""
    lut = {c: i for i, c in enumerate(PROTEIN_ALPHABET)}
    return np.array([lut[c] for c in seq.upper()], dtype=np.uint8)


def decode_protein(codes: np.ndarray) -> str:
    return "".join(PROTEIN_ALPHABET[int(c)] for c in codes)


def random_protein(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform random sequences over the 20 standard amino acids."""
    return rng.integers(0, 20, size=shape).astype(np.uint8)


def blosum62_params(gap_open: int = 11, gap_extend: int = 1):
    """BLOSUM62 with the classic BLAST gap penalties (11, 1)."""
    return ScoringParams(BLOSUM62, gap_open=gap_open, gap_extend=gap_extend)
