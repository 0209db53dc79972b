"""Device-side 2-bit DNA codec.

Port of ``swtpu/kernels/xla/unpack.py`` (XLA in the JAX package, not a
Pallas kernel): shift-and-mask PyTorch ops on uint8 tensors on the
device. Bit layout as ``swtpu_torch.core.encode``: byte i holds bases
4i .. 4i+3, base j in bits 2*(j%4) .. 2*(j%4)+1.
"""

from __future__ import annotations

import numpy as np
import torch

from swtpu_torch.utils.device import resolve_device

_SHIFTS = (0, 2, 4, 6)
_shifts: dict = {}  # device -> the shifts as a uint8 tensor there


def _as_u8(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    return x.to(device=device, dtype=torch.uint8)


def unpack_2bit_device(packed, device=None) -> torch.Tensor:
    """[..., P] uint8 2-bit-packed -> [..., 4P] uint8 codes 0..3 on
    ``device`` (default: the card, or the tensor's own CUDA device)."""
    dev = resolve_device(device, like=packed)
    p = _as_u8(packed, dev)
    # built once a device: a host-to-device copy would stall the stream on
    # every call
    shifts = _shifts.get(str(dev))
    if shifts is None:
        shifts = _shifts[str(dev)] = torch.tensor(_SHIFTS, dtype=torch.uint8, device=dev)
    out = (p[..., :, None] >> shifts) & 3
    return out.reshape(*p.shape[:-1], p.shape[-1] * 4)


def pack_2bit_device(codes, device=None) -> torch.Tensor:
    """[..., 4P] uint8 codes 0..3 -> [..., P] uint8 packed on ``device``;
    codes above 3 keep their low two bits, as in the JAX codec."""
    dev = resolve_device(device, like=codes)
    c = _as_u8(codes, dev)
    g = c.reshape(*c.shape[:-1], -1, 4) & 3
    return g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4) | (g[..., 3] << 6)
