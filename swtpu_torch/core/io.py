"""Sequence I/O: FASTA, DNA only.

Port of the DNA half of ``swtpu/core/io.py``. DNA letters ACGT(acgt) map
to 0..3; N and any other letter map to the query pad code 4, which never
matches. Protein input and the 2-bit ``.npz`` container are not ported
yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

_DNA_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _DNA_LUT[ord(_c)] = _i
    _DNA_LUT[ord(_c.lower())] = _i


def encode_dna(seq: str) -> np.ndarray:
    """DNA string → codes 0..3 (unknown letters → pad 4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _DNA_LUT[raw]


def decode_dna(codes: np.ndarray) -> str:
    return "".join("ACGTN"[min(int(c), 4)] for c in codes)


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) records."""
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name, chunks = line[1:].split()[0] if len(line) > 1 else "", []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def load_fasta_batch(
    path: str, pad_to: int = 0, pad_code: int = 4
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Read a DNA FASTA file into a padded [N, L] uint8 batch.

    Returns (names, batch, lengths); L = max length rounded up to pad_to
    (if nonzero). Unknown/ambiguous letters become pad codes.
    """
    names, seqs = [], []
    for name, seq in read_fasta(path):
        names.append(name)
        seqs.append(encode_dna(seq))
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    L = int(lengths.max()) if seqs else 0
    if pad_to:
        L = -(-L // pad_to) * pad_to
    batch = np.full((len(seqs), L), pad_code, dtype=np.uint8)
    for i, s in enumerate(seqs):
        batch[i, : len(s)] = s
    return names, batch, lengths


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")
