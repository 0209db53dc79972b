"""Where a call runs: the CUDA card unless the caller asks for the CPU.

``device=None`` means the card. A tensor already on a CUDA device stays
there; anything else goes to ``"cuda"``, and with no card the call raises
rather than carry on on the CPU. The CPU runs only when the caller names
it (``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None, like=None) -> torch.device:
    """The torch.device a call runs on.

    ``like``: an input tensor; with ``device=None`` a CUDA tensor keeps
    its own device. Raises RuntimeError when the result is a CUDA device
    and no card is present.
    """
    if device is None:
        if isinstance(like, torch.Tensor) and like.device.type == "cuda":
            return like.device
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch tier on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def as_codes(x, device: torch.device) -> torch.Tensor:
    """Sequence codes as a [B, L] uint8 tensor on ``device``.

    Codes above 255 are pads either way (any code >= the alphabet size
    scores as a pad), so they clamp to 255 rather than wrap.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.dtype != torch.uint8:
        if x.dtype.is_floating_point or x.dtype == torch.bool:
            raise TypeError(f"sequence codes must be integers, got {x.dtype}")
        x = x.clamp(min=0, max=255).to(torch.uint8)
    if x.dim() == 1:
        x = x[None]
    if x.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(x.shape)}")
    return x.to(device)
