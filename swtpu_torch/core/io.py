"""Sequence I/O: FASTA (DNA and protein) and the 2-bit packed container.

Port of ``swtpu/core/io.py``. DNA letters ACGT(acgt) map to 0..3; N and
any other letter map to the query pad code 4, which never matches.
Protein uses the 24-letter NCBI order (``swtpu_torch.core.protein``); a
letter outside it raises KeyError. The ``.npz`` container holds DNA in
the 2-bit wire format (``core/encode.py``) with an ``ambig`` bitmask for
in-length ambiguity codes; files written by either package load
identically in both.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from swtpu_torch.core.encode import pack_2bit, unpack_2bit
from swtpu_torch.core.protein import encode_protein

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
    path: str, alphabet: str = "dna", pad_to: int = 0, pad_code: int = 4
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Read a FASTA file into a padded [N, L] uint8 batch.

    Returns (names, batch, lengths); L = max length rounded up to pad_to
    (if nonzero). ``alphabet`` is "dna" (unknown/ambiguous letters become
    pad codes) or anything else for protein (``encode_protein``).
    """
    names, seqs = [], []
    encode = encode_dna if alphabet == "dna" else encode_protein
    for name, seq in read_fasta(path):
        names.append(name)
        seqs.append(encode(seq))
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


def save_packed_batch(
    path: str, names: List[str], batch: np.ndarray, lens: np.ndarray
) -> None:
    """Write a DNA batch as a 2-bit-packed .npz container (the reference's
    packed wire format, source.cpp:1580-1583, as a batch file).

    batch: [N, L] uint8 codes (pads allowed). L is padded to a multiple
    of 4. Codes > 3 *within* lens (ambiguity codes like N) are recorded
    in a packed ``ambig`` bitmask, so that load restores them as pad
    codes instead of 'A'; the mask is written only when such a code
    exists, so clean files carry none.
    """
    batch = np.asarray(batch, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    L = -(-batch.shape[1] // 4) * 4
    if L != batch.shape[1]:
        batch = np.pad(batch, ((0, 0), (0, L - batch.shape[1])))
    packed = pack_2bit(np.where(batch > 3, 0, batch))
    in_len = np.arange(batch.shape[1])[None, :] < lens[:, None]
    ambig = (batch > 3) & in_len
    arrays = dict(
        packed=packed, lens=lens, names=np.asarray(names, dtype=object)
    )
    if ambig.any():
        arrays["ambig"] = np.packbits(ambig, axis=1)
    np.savez_compressed(path, **arrays)


def load_packed_batch(
    path: str, pad_to: int = 0, pad_code: int = 4, device=False
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Read a 2-bit-packed .npz batch; inverse of save_packed_batch.

    Returns (names, batch, lengths) like load_fasta_batch. ``device``:
    False (the default) decodes on the host with numpy and returns a
    numpy batch; True decodes on the card (``kernels/unpack.py``) and
    returns a CUDA tensor; a ``torch.device`` or a device string decodes
    there with the same torch ops and returns a tensor on it. Positions
    past each length, and in-length ambiguity codes, hold ``pad_code``.
    """
    if device is not False:
        from swtpu_torch.utils.device import resolve_device

        dev = resolve_device("cuda" if device is True else device)
    z = np.load(path, allow_pickle=True)
    packed, lens = z["packed"], z["lens"].astype(np.int64)
    names = [str(n) for n in z["names"]]
    mask = None
    if "ambig" in z.files:  # in-length ambiguity codes (see save)
        mask = ~np.unpackbits(z["ambig"], axis=1).astype(bool)
    L = packed.shape[1] * 4
    Lp = -(-L // pad_to) * pad_to if pad_to else L
    in_len = np.arange(L)[None, :] < lens[:, None]
    mask = in_len if mask is None else in_len & mask[:, :L]
    if device is False:
        batch = np.where(mask, unpack_2bit(packed), np.uint8(pad_code))
        if Lp != L:
            batch = np.pad(
                batch, ((0, 0), (0, Lp - L)), constant_values=pad_code
            )
        return names, batch, lens
    import torch

    from swtpu_torch.kernels.unpack import unpack_2bit_device

    batch = unpack_2bit_device(packed, dev)
    batch = torch.where(
        torch.from_numpy(mask).to(dev), batch,
        torch.tensor(pad_code, dtype=torch.uint8, device=dev),
    )
    if Lp != L:
        batch = torch.nn.functional.pad(batch, (0, Lp - L), value=pad_code)
    return names, batch, lens
