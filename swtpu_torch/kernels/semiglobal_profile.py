"""Batched semi-global and global alignment scores and endpoints under a
general substitution matrix (4x4 DNA, protein with BLOSUM62), linear or
affine gaps: the CUDA kernel and its plain PyTorch version.

Port of ``swtpu/kernels/pallas/semiglobal_profile.py``
(``semiglobal_batch_profile_pallas``). The kernel is the profile form of
``csrc/sw_semiglobal.cu``: it looks each cell up in the plain tier's
extended table (``sw_profile.profile_table``), pads at -2^20 where the
TPU kernel scored them at -128, on the [B, L] codes as given (no
transposes). The plain version is the table tier of
``semiglobal_scan.py``.

``semiglobal_profile`` runs where its device says: on the CPU the plain
version, on a CUDA device the kernel, for every scoring the plain tier
takes (at most 30 letters, :func:`semiglobal_profile_refusal`; gaps of
either sign, entries of any size), never the plain version there. It
counts its launches as ``semiglobal_batch.semiglobal_batch`` does.
"""

from __future__ import annotations

from swtpu_torch.core.scoring import ScoringParams
from swtpu_torch.kernels.semiglobal_batch import (
    codes,
    count,
    lens_tensor,
    semiglobal_launch_t,
)
from swtpu_torch.kernels.semiglobal_scan import semiglobal_batch_general
from swtpu_torch.kernels.sw_profile import MAX_LETTERS, profile_table
from swtpu_torch.utils.device import resolve_device


def semiglobal_profile_refusal(params: ScoringParams):
    """Why the profile form does not take ``params``, or None: more letters
    than its lane table (and the plain tier's extended table) holds."""
    if params.alphabet_size > MAX_LETTERS:
        return (f"the semi-global profile kernel takes at most {MAX_LETTERS} letters "
                f"(got {params.alphabet_size}), as the plain tier's extended table does")
    return None


def semiglobal_profile_plain(qs, ts, params: ScoringParams, lens_q=None,
                             lens_t=None, pin_end=False, device=None):
    """Plain PyTorch version of :func:`semiglobal_profile` (the XLA
    table tier's anti-diagonal scan)."""
    return semiglobal_batch_general(
        qs, ts, params, lens_q=lens_q, lens_t=lens_t, pin_end=pin_end,
        device=device,
    )


def semiglobal_profile(qs, ts, params: ScoringParams, lens_q=None, lens_t=None,
                       pin_end=False, device=None):
    """Batched semi-global scores + endpoints under a general matrix.

    qs: [B, n] codes 0..A-1, ts: [B, m] codes (numpy or torch), A the
    alphabet size; optional per-pair lengths; ``pin_end`` gives global
    alignment. Returns (score, end_i, end_j) int32 [B] on ``device``
    (default: the card), identical to
    ``semiglobal_scan.semiglobal_batch_general``.
    """
    dev = resolve_device(device, like=qs)
    if dev.type == "cpu":
        return semiglobal_profile_plain(qs, ts, params, lens_q, lens_t, pin_end,
                                        dev)
    reason = semiglobal_profile_refusal(params)
    if reason:
        raise NotImplementedError(reason)
    q, t = codes(qs, ts, dev, "semi-global profile")
    B = q.shape[0]
    affine = not params.is_linear
    out = semiglobal_launch_t(
        q, t, int(abs(params.matrix).max()), 0, params.gap_open, params.gap_extend,
        affine, pin_end,
        lens_tensor(lens_q, B, dev), lens_tensor(lens_t, B, dev),
        table=profile_table(params, dev), n_codes=params.alphabet_size + 1,
    )
    count(semiglobal_profile, affine, pin_end)
    return out


semiglobal_profile.launches = 0
semiglobal_profile.launches_affine = 0
semiglobal_profile.launches_pinned = 0
semiglobal_profile.launches_affine_pinned = 0
