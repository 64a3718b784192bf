"""Plain PyTorch versions of the port's kernels.

The CPU path of each kernel wrapper, and what the kernels are held against
on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def pearson_dissimilarity_ref(z: torch.Tensor) -> torch.Tensor:
    """``1 - Z Z^T`` in fp32 for row-standardised ``z`` (K, F)."""
    z = z.float()
    return 1.0 - z @ z.T


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Dense softmax attention over flattened (batch*heads) slices.

    ``q`` is (BH, S, d); ``k`` and ``v`` are (BHk, T, d) with BH a multiple
    of BHk: query slice ``i`` reads KV slice ``i // (BH / BHk)``, which is
    grouped-query attention on the flattened layout (BHk == BH is plain
    multi-head).  fp32 scores masked with ``-1e30``; the output is in
    ``q``'s dtype.  Positions are indices, and the window applies whenever
    it is given, causal or not (``repro/kernels/ref.py``).
    """
    rep = q.shape[0] // k.shape[0]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    d = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(s.shape[1:], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", w, v.float()).to(q.dtype)


def flash_attention_bhsd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`flash_attention_ref` in model layout: ``q`` (B, S, Hq, d),
    ``k``/``v`` (B, T, Hk, d) with Hq a multiple of Hk; returns (B, S, Hq, d).
    """
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qf = q.transpose(1, 2).reshape(b * hq, s, d)
    kf = k.transpose(1, 2).reshape(b * hk, -1, d)
    vf = v.transpose(1, 2).reshape(b * hk, -1, d)
    of = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return of.reshape(b, hq, s, d).transpose(1, 2)


def ssd_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in plain PyTorch from a zero state: the port's
    :func:`repro_torch.models.ssm.ssd_chunked`, which the SSM model module
    owns (imported here at call time: that module imports the kernels)."""
    from repro_torch.models.ssm import ssd_chunked

    return ssd_chunked(x, dt, a, b_in, c_in, chunk)


def ssd_sequential(x, dt, a, b_in, c_in):
    """The per-step recurrence, the oracle of the chunked form."""
    from repro_torch.models.ssm import ssd_sequential_ref

    return ssd_sequential_ref(x, dt, a, b_in, c_in)
