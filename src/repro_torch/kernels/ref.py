"""Plain PyTorch versions of the port's kernels.

The CPU path of each kernel wrapper, and what the kernels are held against
on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def ssd_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor,
    dy: torch.Tensor, d_final: Optional[torch.Tensor] = None, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The vector-Jacobian product of :func:`ssd_scan_ref` (the chunked SSD
    from a zero state), written out in the backward kernel's phases in fp32:
    ``dy`` (B, S, H, P) is the cotangent of y, ``d_final`` (B, H, P, N) that
    of the final state (None: zero).  Returns ``(dx, ddt, da, dB, dC)``: dx,
    dB and dC in their inputs' dtypes, ddt (B, S, H) and da (H,) fp32.

    Per chunk c (positions i, j; cum the inclusive cumsum of dt * a over the
    chunk, Q its last position, h_c the state entering the chunk):

    1. the chunk's own state S_c = sum_j exp(cum_Q - cum_j) dt_j x_j (x) B_j
       and U_c = sum_i exp(cum_i) dy_i (x) C_i;
    2. h_c forward over the chunks, h_{c+1} = exp(cum_Q) h_c + S_c, and the
       cotangent G_c of h_{c+1} backward, G_{nc-1} = d_final,
       G_{c-1} = exp(cum_Q) G_c + U_c;
    3. per key j: v_j = sum_{i>=j} (C_i.B_j) exp(cum_i - cum_j) dy_i
       + exp(cum_Q - cum_j) G_c B_j, dx_j = dt_j v_j, the direct part of
       ddt_j x_j.v_j, and dB_j = dt_j [sum_{i>=j} exp(cum_i - cum_j)
       (dy_i.x_j) C_i + exp(cum_Q - cum_j) G_c^T x_j], summed over heads;
    4. per query i: dC_i = sum_{j<=i} exp(cum_i - cum_j) dt_j (dy_i.x_j) B_j
       + exp(cum_i) h_c^T dy_i, summed over heads;
    5. the cotangent of cum: with M_ij = (C_i.B_j) exp(cum_i - cum_j) dt_j
       (dy_i.x_j) on j <= i and T_j = exp(cum_Q - cum_j) dt_j x_j.(G_c B_j),
       dcum_i = sum_j M_ij - sum_k M_ki + exp(cum_i) dy_i.(h_c C_i) - T_i,
       and position Q also gets sum_j T_j + exp(cum_Q) <G_c, h_c>; a
       reverse cumsum over the chunk gives d(dt * a), hence ddt += a d(dt a)
       and da = sum over (b, s) of dt d(dt a).

    A ragged S is zero-padded to whole chunks, as the forward pads it: the
    padded positions carry dt = 0, so cum_Q is the last real position's.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in, c_in = (F.pad(t, (0, 0, 0, pad)) for t in (b_in, c_in))
    nc, q = (s + pad) // chunk, chunk
    xf = x.reshape(bsz, nc, q, h, p).float()
    dyf = dy.reshape(bsz, nc, q, h, p).float()
    dtf = dt.reshape(bsz, nc, q, h).float()
    bf = b_in.reshape(bsz, nc, q, n).float()
    cf = c_in.reshape(bsz, nc, q, n).float()
    af = a.float()

    # Phase 1: cum, the chunks' own states and U_c.
    cum = torch.cumsum(dtf * af, dim=2)                               # (B,nc,q,H)
    ecum = torch.exp(cum)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)                       # exp(cum_Q - cum_j)
    decay = torch.exp(cum[:, :, -1, :])                               # (B,nc,H)
    s_chunk = torch.einsum("bckhp,bckn->bchpn", (to_end * dtf)[..., None] * xf, bf)
    u_chunk = torch.einsum("bcqhp,bcqn->bchpn", ecum[..., None] * dyf, cf)

    # Phase 2: the entering states forward, their cotangents backward.
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + s_chunk[:, c]
    h_in = torch.stack(entering, dim=1)                               # (B,nc,H,P,N)
    g = (d_final.float() if d_final is not None
         else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    cotangents = [g] * nc
    for c in reversed(range(nc)):
        cotangents[c] = g
        g = g * decay[:, c, :, None, None] + u_chunk[:, c]
    g_out = torch.stack(cotangents, dim=1)                            # (B,nc,H,P,N)

    # The chunk's pair terms: L_ij = exp(cum_i - cum_j) on j <= i, by a select.
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.where(causal[None, None, :, :, None],
                       torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :]),
                       torch.zeros((), device=x.device))              # (B,nc,i,j,H)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    dyx = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    z = lmat * dyx * dtf[:, :, None, :, :]                            # L_ij dt_j (dy_i.x_j)

    # Phase 3: per key.
    g_b = torch.einsum("bchpn,bcjn->bcjhp", g_out, bf)                # G_c B_j
    v = torch.einsum("bcijh,bcihp->bcjhp", lmat * cb[..., None], dyf) + to_end[..., None] * g_b
    dx = dtf[..., None] * v
    ddt = (xf * v).sum(-1)
    db = (torch.einsum("bcijh,bcin->bcjn", z, cf)
          + torch.einsum("bcjhp,bchpn->bcjn", (to_end * dtf)[..., None] * xf, g_out))

    # Phase 4: per query.
    h_dy = torch.einsum("bchpn,bcihp->bcihn", h_in, dyf)              # h_c^T dy_i
    dc = torch.einsum("bcijh,bcjn->bcin", z, bf) + torch.einsum("bcih,bcihn->bcin", ecum, h_dy)

    # Phase 5: the cotangent of cum, back through the cumsum to dt and a.
    m = z * cb[..., None]
    t_j = to_end * dtf * (xf * g_b).sum(-1)
    dcum = m.sum(3) - m.sum(2) + ecum * torch.einsum("bcihn,bcin->bcih", h_dy, cf) - t_j
    dcum[:, :, -1, :] += t_j.sum(2) + decay * (g_out * h_in).sum((-2, -1))
    d_da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + af * d_da
    da = (dtf * d_da).sum((0, 1, 2))

    def cut(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return t.reshape(bsz, nc * q, *t.shape[3:])[:, :s].to(dtype)

    return (cut(dx, x.dtype), cut(ddt, torch.float32), da,
            cut(db, b_in.dtype), cut(dc, c_in.dtype))


def ssd_sequential(x, dt, a, b_in, c_in):
    """The per-step recurrence, the oracle of the chunked form."""
    from repro_torch.models.ssm import ssd_sequential_ref

    return ssd_sequential_ref(x, dt, a, b_in, c_in)
