"""Sequence encoding utilities: the 2-bit DNA codec and seeded generators.

Copy of ``swtpu/core/encode.py`` (numpy only, so seeded data is the same
on both sides). DNA bases are integers 0..3 (A, C, G, T). The device
decoder is ``swtpu_torch.kernels.unpack``.

Bit layout parity with the reference (``source.cpp:1580-1583``): byte ``i``
of the packed form holds bases ``4*i .. 4*i+3``, base ``j`` in bits
``2*(j%4) .. 2*(j%4)+1`` (little-endian within the byte):
``dest[i] = (src[i/4] >> (2*(i%4))) & 3``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pack_2bit(seq: np.ndarray) -> np.ndarray:
    """Pack base-per-byte DNA (values 0..3) into 2-bit form.

    Length must be a multiple of 4. Inverse of :func:`unpack_2bit`.
    """
    seq = np.asarray(seq, dtype=np.uint8)
    if seq.shape[-1] % 4 != 0:
        raise ValueError("sequence length must be a multiple of 4")
    s = seq.reshape(*seq.shape[:-1], -1, 4).astype(np.uint8)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    return np.bitwise_or.reduce(s << shifts, axis=-1).astype(np.uint8)


def unpack_2bit(packed: np.ndarray) -> np.ndarray:
    """Unpack 2-bit DNA into base-per-byte form.

    Byte/bit order matches the reference scalar ``unpack``
    (``source.cpp:1580-1583``).
    """
    packed = np.asarray(packed, dtype=np.uint8)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    out = (packed[..., :, None] >> shifts) & 3
    return out.reshape(*packed.shape[:-1], -1)


def random_dna(
    rng: np.random.Generator, shape: Tuple[int, ...]
) -> np.ndarray:
    """Uniform i.i.d. DNA, the reference's kernel-parity input model
    (``uniform_int_distribution dna(0,3)``, ``source.cpp:2945``)."""
    return rng.integers(0, 4, size=shape, dtype=np.int64).astype(np.uint8)


def revcomp(codes: np.ndarray, length: Optional[int] = None) -> np.ndarray:
    """Reverse complement of a DNA code array (A=0 <-> T=3, C=1 <-> G=2).

    With ``length`` (a padded batch row's real length), only the first
    ``length`` codes are reverse-complemented in place and trailing pad
    codes (>= 4) stay where they are, so padded batches remain padded at
    the tail. Pad codes inside the window are preserved unchanged.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = int(length) if length is not None else len(codes)
    out = codes.copy()
    head = codes[:L]
    out[:L] = np.where(head < 4, 3 - head, head)[::-1]
    return out


def mutate(
    rng: np.random.Generator,
    seq: np.ndarray,
    p_mismatch: float = 0.1,
    p_insert: float = 0.1,
    p_delete: float = 0.1,
    out_len: Optional[int] = None,
) -> np.ndarray:
    """Edit-process mutation generator (~70% identity at defaults).

    Mirrors the reference's homologous-pair generator
    (``source.cpp:2750-2771``): walk the source sequence; at each
    position, with p_mismatch substitute a random base, with p_insert
    emit a random base without consuming, with p_delete consume without
    emitting, else copy. Output is truncated/padded with random bases to
    ``out_len`` (default: len(seq)).
    """
    seq = np.asarray(seq, dtype=np.uint8)
    n = len(seq)
    out_len = n if out_len is None else out_len
    out = []
    i = 0
    while i < n and len(out) < out_len:
        r = rng.random()
        if r < p_mismatch:
            out.append(rng.integers(0, 4))
            i += 1
        elif r < p_mismatch + p_insert:
            out.append(rng.integers(0, 4))
        elif r < p_mismatch + p_insert + p_delete:
            i += 1
        else:
            out.append(seq[i])
            i += 1
    while len(out) < out_len:
        out.append(rng.integers(0, 4))
    return np.asarray(out[:out_len], dtype=np.uint8)
