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


def _flash_scores(
    q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 scaled scores (BH, S, T) of flat ``q`` over the repeated ``k``,
    and the mask (S, T) of the pairs kept."""
    rep = q.shape[0] // k.shape[0]
    kf = k.float().repeat_interleave(rep, dim=0)
    s = torch.einsum("bsd,btd->bst", q.float(), kf) / math.sqrt(q.shape[-1])
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(s.shape[1:], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    return s, mask


def flash_attention_lse_ref(
    q: torch.Tensor, k: torch.Tensor, causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """The fp32 logsumexp (BH, S) of each query row's scaled scores over the
    keys it keeps: what the kernel's forward saves for its backward."""
    s, mask = _flash_scores(q, k, causal, window)
    return torch.logsumexp(torch.where(mask[None], s, torch.full_like(s, NEG_INF)), dim=-1)


def flash_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    d_o: torch.Tensor, lse: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The textbook gradients of :func:`flash_attention_ref` in fp32 from
    what the forward saves: flat ``q`` (BH, S, d), ``k``/``v`` (BHk, T, d),
    the output ``o``, its gradient ``d_o`` and the logsumexp ``lse`` (BH, S).

    ``P = exp(S - lse)`` on the kept pairs (0 elsewhere), ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - rowsum(dO o))``, ``dQ = dS K / sqrt(d)``
    and ``dK = dS^T Q / sqrt(d)``; dK and dV summed over the query heads of
    each KV head.  Returns (dq, dk, dv) in the inputs' dtypes.
    """
    rep = q.shape[0] // k.shape[0]
    s, mask = _flash_scores(q, k, causal, window)
    p = torch.where(mask[None], torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dof = d_o.float()
    kf = k.float().repeat_interleave(rep, dim=0)
    vf = v.float().repeat_interleave(rep, dim=0)
    dv = torch.einsum("bst,bsd->btd", p, dof)
    dp = torch.einsum("bsd,btd->bst", dof, vf)
    ds = p * (dp - (dof * o.float()).sum(-1, keepdim=True))
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bst,btd->bsd", ds, kf) * scale
    dk = torch.einsum("bst,bsd->btd", ds, q.float()) * scale

    def group(x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(0, (k.shape[0], rep)).sum(1)

    return dq.to(q.dtype), group(dk).to(k.dtype), group(dv).to(v.dtype)


def flash_attention_bhsd_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    d_o: torch.Tensor, lse: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_bwd_ref` in model layout: ``q``, ``o``,
    ``d_o`` (B, S, Hq, d), ``k``/``v`` (B, T, Hk, d), ``lse`` (B, Hq, S)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]

    def flat(x: torch.Tensor, h: int) -> torch.Tensor:
        return x.transpose(1, 2).reshape(b * h, -1, d)

    dq, dk, dv = flash_attention_bwd_ref(
        flat(q, hq), flat(k, hk), flat(v, hk), flat(o, hq), flat(d_o, hq),
        lse.reshape(b * hq, s), causal=causal, window=window,
    )
    return (dq.reshape(b, hq, s, d).transpose(1, 2),
            dk.reshape(b, hk, -1, d).transpose(1, 2),
            dv.reshape(b, hk, -1, d).transpose(1, 2))


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
