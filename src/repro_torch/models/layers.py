"""Shared neural-net layers of the dense transformer family, the PyTorch
port of ``repro.models.layers``.

Conventions, as in the reference:

* a *module* is an ``init_*(generator, cfg, device) -> params`` /
  ``apply(params, ...)`` pair of plain functions; params are dicts of
  tensors in the reference's layouts (``x @ w`` dense weights, (D, H, hd)
  query projections, K and V fused on a stack axis), so weights carry over
  from the JAX package unchanged;
* attention is grouped-query with an optional sliding window.  On a full
  sequence it goes through :func:`repro_torch.kernels.ops.flash_attention_bhsd`
  (the hand-written kernel on CUDA, its plain version on the CPU) where the
  reference calls its jnp oracle ``attention_chunked``; one decode token
  over a cache goes through :func:`attention_decode`; several tokens over a
  cache go through :func:`attention_chunked`, a plain PyTorch copy of the
  reference's online softmax over KV chunks (the reference computes that
  branch in jnp too, outside any Pallas kernel).

Every ``init_*`` with weights has a ``spec_*`` returning the reference's
ideal layout as a tree of the port's :class:`~repro_torch.sharding.policy.P`
for a :class:`~repro_torch.sharding.policy.ShardingPolicy`; the apply
functions take the policy as a trailing argument (``TP_POLICY`` by
default) and constrain activations with ``shard_act`` at the reference's
sites.  On a mesh (parameters placed as ``DTensor``s by ``fit_specs``)
those constraints redistribute; off a mesh they return their input, so the
computation is the one-device one, bit for bit.  Where the reference wraps
a layer body in ``jax.checkpoint`` under ``cfg.remat``, the port calls it
through :func:`remat`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import tree_leaves
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import (
    column_einsum, gather_fsdp, is_dtensor, local_extent, mesh_pad, mesh_reduce, mesh_sum,
    row_einsum, write_rows,
)

Params = Dict[str, Any]

NEG_INF = -1e30


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, rematerialised in training: under ``cfg.remat``, with
    grad enabled and some tensor of ``args`` requiring grad, through
    ``torch.utils.checkpoint`` (non-reentrant), so that the layer body's
    activations are recomputed in the backward instead of kept — the
    reference's ``jax.checkpoint`` of the body.  Elsewhere (inference) a
    plain call: nothing is recomputed and no kernel launches twice."""
    if (cfg.remat and torch.is_grad_enabled()
            and any(t.requires_grad for t in tree_leaves(list(args)))):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# Initialisers
# --------------------------------------------------------------------------

def dense_init(
    generator: torch.Generator, in_dim: int, out_shape: Sequence[int],
    dtype: torch.dtype, device: torch.device,
) -> torch.Tensor:
    """Truncated-normal fan-in init (std 1/sqrt(in_dim), cut at 2 std).

    Drawn in fp32 on the generator's device, then moved and cast: a CUDA
    generator draws on the card, so full-width weights never cross the host.
    On ``meta`` nothing is drawn: the tensor has the shape and dtype only.
    """
    shape = (in_dim, *out_shape)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (1.0 / math.sqrt(in_dim))).to(device=device, dtype=dtype)


def embed_init(
    generator: torch.Generator, vocab: int, dim: int, dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    """Normal (std 0.02) embedding, drawn as :func:`dense_init` draws (on
    ``meta`` not at all)."""
    if device.type == "meta":
        return torch.empty((vocab, dim), dtype=dtype, device=device)
    t = torch.empty((vocab, dim), device=generator.device)
    t.normal_(0.0, 1.0, generator=generator)
    return (t * 0.02).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def spec_rmsnorm() -> Params:
    return {"scale": P(None)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, cast back to ``x``'s dtype.  A ``DTensor`` whose
    channels are split (Mamba2's gated norm over ``d_inner``) is normed per
    rank (:func:`_rmsnorm_on_mesh`)."""
    if is_dtensor(x) and any(pl.is_shard(x.ndim - 1) for pl in x.placements):
        return _rmsnorm_on_mesh(params, x, eps)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def _rmsnorm_on_mesh(params: Params, x: Any, eps: float) -> Any:
    """:func:`rmsnorm` of a ``DTensor`` whose channels are split, through
    ``local_map``: the local sum of squares is all-reduced (a (..., 1)
    field, never the activations), then each rank scales its own channels.
    In the backward only that field's gradient is all-reduced
    (:func:`~repro_torch.sharding.utils.mesh_sum`); the scale's gradient
    lands in its own channels, a partial sum over the rows' shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, width, last = x.device_mesh, x.shape[-1], x.ndim - 1
    split = [mdim for mdim, pl in enumerate(x.placements) if pl.is_shard(last)]
    # Per mesh dim, the placements of (the scale, its gradient).
    rows = [(Shard(0), Shard(0)) if pl.is_shard(last) else
            (Replicate(), Partial()) if pl.is_shard() else (Replicate(), Replicate())
            for pl in x.placements]
    spl, sgrad = (list(c) for c in zip(*rows))

    def norm(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        x32 = t.float()
        var = mesh_sum(x32.square().sum(dim=-1, keepdim=True), mesh, split) / width
        return (x32 * torch.rsqrt(var + eps) * scale.float()).to(t.dtype)

    return local_map(
        norm, out_placements=list(x.placements), in_placements=(x.placements, spl),
        in_grad_placements=(x.placements, sgrad), device_mesh=mesh, redistribute_inputs=True,
    )(x, params["scale"])


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(
    head_dim: int, theta: float, device: Optional[torch.device] = None
) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate halves (not interleaved pairs), angles in fp32.

    ``x``: (..., S, H, Dh); ``positions``: (..., S).
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (Dh/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, optional sliding window)
# --------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = cfg.params_dtype()
    d, hd = cfg.d_model, cfg.head_dim
    wq = dense_init(generator, d, (cfg.n_heads, hd), dtype, device)
    wk = dense_init(generator, d, (cfg.n_kv_heads, hd), dtype, device)
    wv = dense_init(generator, d, (cfg.n_kv_heads, hd), dtype, device)
    wo = dense_init(generator, cfg.n_heads * hd, (d,), dtype, device)
    return {
        "wq": wq,
        "w_kv": torch.stack([wk, wv], dim=1),  # (D, 2, Hk, hd)
        "wo": wo.reshape(cfg.n_heads, hd, d),
    }


def project_kv(params: Params, x: torch.Tensor,
               q: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V (B, S, Hk, Dh) of ``x``.  With ``q``, the query that attends
    over them on a mesh, they come back laid out for that attention: where
    ``q``'s heads split over ranks that share a KV head
    (:func:`~repro_torch.kernels.ops.mesh_heads`), each rank projects only
    the KV head its query heads read, and K and V have one head per query
    split (:func:`expand_heads`); :func:`collapse_heads` gives the cache's
    Hk heads back."""
    w = params["w_kv"]
    if q is not None:
        w = expand_heads(w, 2, q)
    kv = column_einsum("bsd,dthk->bsthk", x, w, 2, 3)
    return kv[:, :, 0], kv[:, :, 1]


def expand_heads(t: Any, dim: int, q: Any) -> Any:
    """``t`` (a ``DTensor`` whose dimension ``dim`` holds Hk KV heads) with
    one head for each of the ways ``q``'s query heads split, where ranks
    share a KV head: each rank keeps, through ``local_map``, the KV head its
    own query heads read, and its gradient comes back whole, a partial sum
    over the ranks sharing a head.  Elsewhere (off a mesh, heads split
    alike or not at all) ``t`` itself.  ``t`` is first gathered whole over
    the dimensions that split the query heads."""
    if not (is_dtensor(t) and is_dtensor(q)):
        return t
    heads = ops.mesh_heads(q, t.shape[dim])
    if heads.narrow is None or any(pl.is_shard(2) for pl in heads.kv):
        return t
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    split = [qp.is_shard(2) for qp in heads.q]
    whole = [Replicate() if sp else pl for sp, pl in zip(split, t.placements)]
    out = [Shard(dim) if sp else pl for sp, pl in zip(split, whole)]
    grad = [Partial() if sp else pl for sp, pl in zip(split, whole)]
    off, n = heads.narrow
    return local_map(
        lambda a: a.narrow(dim, off, n).contiguous(), out_placements=out,
        in_placements=(whole,), in_grad_placements=(grad,),
        device_mesh=t.device_mesh, redistribute_inputs=True,
    )(t)


def collapse_heads(t: Any, hk: int, dest: Sequence[Any]) -> Any:
    """The Hk KV heads of ``t`` (B, S, E, Dh), which :func:`expand_heads`
    laid out with E heads, as the cache holds them; ``t`` itself where it
    has Hk heads.

    Each mesh dimension that splits the E heads splits the sequence
    instead where ``dest`` (the placements of one layer of the cache,
    (B, T, Hk, Dh)) splits it and S divides: one all-to-all, after which a
    rank holds all heads of its own positions and keeps every (E / Hk)-th.
    Elsewhere it is gathered: every rank then holds the layer's K or V
    over the whole sequence."""
    e = t.shape[2]
    if e == hk:
        return t
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = t.device_mesh
    pls, ways = [], 1
    for mdim, (pl, d) in enumerate(zip(t.placements, dest)):
        if not pl.is_shard(2):
            pls.append(pl)
        elif d == Shard(1) and t.shape[1] % (ways * mesh.size(mdim)) == 0:
            ways *= mesh.size(mdim)
            pls.append(Shard(1))
        else:
            pls.append(Replicate())
    return local_map(
        lambda a: a[:, :, ::e // hk].contiguous(), out_placements=pls, in_placements=(pls,),
        device_mesh=mesh, redistribute_inputs=True,
    )(t)


def write_cache_layer(buf: Any, i: int, t: Any, hk: int, start: int = 0) -> None:
    """Layer ``i`` of the KV cache ``buf`` (L, B, T, Hk, Dh), in place, from
    a prefill's K or V ``t`` (B, S, E, Dh) as the attention read it: its
    positions go to slots ``start``, ``start + 1``, ... wrapping past T (a
    sliding window's ring).  On a mesh ``t`` is moved straight into the
    layer's own shards (:func:`collapse_heads` to its layout), so no rank
    holds more than this one layer's K or V whole."""
    layer = buf[i]
    if is_dtensor(layer):
        t = collapse_heads(t, hk, layer.placements)
    if start == 0 and t.shape[1] == buf.shape[2]:
        write_rows(buf, 0, i, t[None])  # in the layer's layout: each rank copies its shard
    else:
        write_rows(layer, 1, start, t)


def spec_attention(policy: ShardingPolicy) -> Params:
    """Ideal specs; ``fit_specs`` drops axes that do not divide (e.g. MQA's
    single KV head over a 16-way model axis falls back to replicated)."""
    m, f = policy.physical("model"), policy.physical("fsdp")
    return {
        "wq": P(f, m, None),
        "w_kv": P(f, None, m, None),
        "wo": P(m, None, f),
    }


def _causal_window_mask(
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]
) -> torch.Tensor:
    """(..., S, T) True where attention is allowed."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        mask &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return mask


def _groupable(q: torch.Tensor, hk: int) -> torch.Tensor:
    """``q`` (B, S, Hq, Dh) ready to view as (.., Hk, G, Dh): on a mesh a
    head split that the Hk KV heads do not divide (GQA over a wide model
    axis, whose cache shards the sequence instead) is gathered; q is one
    token's or one prompt's worth, never a cache."""
    if not is_dtensor(q):
        return q
    from torch.distributed.tensor import Replicate

    mesh, split, pls = q.device_mesh, 1, []
    for mdim, pl in enumerate(q.placements):
        if pl.is_shard(2) and hk % (split * mesh.size(mdim)) == 0:
            split *= mesh.size(mdim)
        elif pl.is_shard(2):
            pl = Replicate()
        pls.append(pl)
    return q if tuple(pls) == tuple(q.placements) else q.redistribute(mesh, pls)


def _masked(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: Optional[int] = None,
    causal: bool = True,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention: full score matrix.  q: (B,S,Hq,Dh); k/v: (B,T,Hk,Dh).
    ``DTensor`` inputs with positions shared by the batch and the keys'
    sequence whole run per rank (:func:`_attend_on_mesh`)."""
    if _splits_rows_or_heads(q, k) and q_pos.dim() == 1 and k_pos.dim() == 1:
        return _attend_on_mesh(
            lambda a, b_, c, valid: attention_dense(a, b_, c, q_pos, k_pos, window, causal, valid),
            q, k, v, kv_valid)
    b, s, hq, dh = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = _groupable(q, hk).reshape(b, s, hk, g, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    if causal:
        mask = _causal_window_mask(q_pos, k_pos, window)  # (B?,S,T) or (S,T)
        while mask.dim() < scores.dim():
            mask = mask[:, None] if mask.dim() > 2 else mask[None]
        scores = _masked(scores, mask)
    if kv_valid is not None:
        scores = _masked(scores, kv_valid[:, None, None, None, :])
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(b, s, hq, dh)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: Optional[int] = None,
    causal: bool = True,
    chunk: int = 1024,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the reference's
    ``attention_chunked`` step for step.  q: (B,S,Hq,Dh); k/v: (B,T,Hk,Dh).

    K and V are zero-padded up to a multiple of ``chunk``; the pad's
    positions are int32 max (masked only under ``causal``) and its
    ``kv_valid`` False, as there.  Masked scores are the finite ``NEG_INF``,
    so a query row with no allowed key averages V over every key, pad
    included — the reference's behaviour, kept.
    """
    b, s, hq, dh = q.shape
    t = k.shape[1]
    hk = k.shape[2]
    g = hq // hk
    if t % chunk != 0:
        pad = chunk - t % chunk
        k = mesh_pad(k, (0, 0, 0, 0, 0, pad))
        v = mesh_pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
        if kv_valid is not None:
            kv_valid = F.pad(kv_valid, (0, pad), value=False)
        t = k.shape[1]
    n_chunks = t // chunk
    qg = _groupable(q, hk).reshape(b, s, hk, g, dh).float() / math.sqrt(dh)
    m = torch.full((b, hk, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hk, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, s, dh), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        scores = torch.einsum("bshgd,bthd->bhgst", qg, k[:, sl].float())
        if causal:
            msk = _causal_window_mask(q_pos, k_pos[sl], window)
            while msk.dim() < scores.dim():
                msk = msk[None]
            scores = _masked(scores, msk)
        if kv_valid is not None:
            scores = _masked(scores, kv_valid[:, None, None, None, sl])
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh)
    return out.to(q.dtype)


def attention_decode(
    q: torch.Tensor,        # (B, 1, Hq, Dh)
    k: torch.Tensor,        # (B, T, Hk, Dh)  cache, in its storage dtype
    v: torch.Tensor,
    k_pos: torch.Tensor,    # (T,) absolute positions of cache slots
    q_pos_scalar: int,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token decode attention: one pass over the cache.

    The score tensor is only (B, Hk, G, T), so nothing needs the online
    softmax.  Scores and the weighted sum of V are taken in fp32 over the
    stored values (the reference's ``preferred_element_type=float32``); the
    softmax weights are rounded to V's dtype first, as there.  ``DTensor``
    inputs whose cache keeps its sequence whole run per rank on the local
    batch rows and heads (:func:`_attend_on_mesh`); a cache that splits its
    sequence is attended where it lies (:func:`_decode_on_split_sequence`).
    """
    if _splits_rows_or_heads(q, k):
        return _attend_on_mesh(
            lambda a, b, c, valid: attention_decode(a, b, c, k_pos, q_pos_scalar, window, valid),
            q, k, v, kv_valid)
    if is_dtensor(k) and any(pl.is_shard(1) for pl in k.placements):
        return _decode_on_split_sequence(q, k, v, k_pos, q_pos_scalar, window, kv_valid)
    b, s, hq, dh = q.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one query token, got {s}")
    hk = k.shape[2]
    qg = _groupable(q, hk).reshape(b, hk, hq // hk, dh)
    w = torch.softmax(_decode_scores(qg, k, k_pos, q_pos_scalar, window, kv_valid), dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def _decode_scores(qg: torch.Tensor, k: torch.Tensor, k_pos: torch.Tensor, q_pos_scalar: int,
                   window: Optional[int], kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The masked fp32 scores (B, Hk, G, T) of one query token ``qg``
    (B, Hk, G, Dh) over the cache slots ``k`` (B, T, Hk, Dh) at positions
    ``k_pos``: causal, within ``window``, and where ``kv_valid``."""
    scores = torch.einsum("bhgd,bthd->bhgt", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(qg.shape[-1]))
    mask = k_pos[None, None, None, :] <= q_pos_scalar
    if window is not None:
        mask = mask & ((q_pos_scalar - k_pos[None, None, None, :]) < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    return _masked(scores, mask)


def _decode_on_split_sequence(q, k, v, k_pos, q_pos_scalar: int, window: Optional[int],
                              kv_valid: Optional[Any]):
    """:func:`attention_decode` over a ``DTensor`` cache that splits its
    sequence (B, T, Hk, Dh), on each rank's own slots through ``local_map``,
    as the reference's partitioned softmax does: the local max of the masked
    fp32 scores and an all-reduce max, the local exp and sum and an
    all-reduce sum, the weights (rounded to V's dtype) times the local V and
    an all-reduce sum of that fp32 partial output.  Only the statistics and
    the output move, never the cache; ``q`` (one token) is gathered over the
    sequence's ranks.  ``k_pos`` and ``kv_valid`` are sliced with the slots,
    and a rank whose slots are all masked for a row (or that holds no
    slot) adds nothing to it: its local sum is 0 once the max is the global
    one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = k.device_mesh
    seq = [mdim for mdim, pl in enumerate(k.placements) if pl.is_shard(1)]
    # Per mesh dim, the placements of (q and the output, k_pos, kv_valid):
    # batch rows, slots, KV heads (q's follow) or replicated.
    rows = []
    for pl in k.placements:
        if pl.is_shard(0):
            rows.append((Shard(0), Replicate(), Shard(0)))
        elif pl.is_shard(1):
            rows.append((Replicate(), Shard(0), Shard(1)))
        elif pl.is_shard(2):
            rows.append((Shard(2), Replicate(), Replicate()))
        else:
            rows.append((Replicate(),) * 3)
    qpl, ppl, vpl = (list(c) for c in zip(*rows))

    def whole(t):
        if t is None or is_dtensor(t):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def attend(a, b_, c, kp, valid):
        bl, _, hq, dh = a.shape
        hk = b_.shape[2]
        scores = _decode_scores(a.reshape(bl, hk, hq // hk, dh), b_, kp, q_pos_scalar, window,
                                valid)
        # The sequence splits like torch.chunk, so a rank may hold no slot:
        # its max is then the mask value, and its sum 0.
        top = (scores.amax(dim=-1, keepdim=True) if scores.shape[-1] else
               scores.new_full((*scores.shape[:-1], 1), NEG_INF))
        top = mesh_reduce(top, "max", mesh, seq)
        e = torch.exp(scores - top)
        w = e / mesh_reduce(e.sum(dim=-1, keepdim=True), "sum", mesh, seq)
        out = torch.einsum("bhgt,bthd->bhgd", w.to(c.dtype).float(), c.float())
        out = mesh_reduce(out, "sum", mesh, seq)
        return out.reshape(bl, 1, hq, dh).to(a.dtype)

    vrows = None if kv_valid is None else vpl
    return local_map(
        attend, out_placements=qpl, in_placements=(qpl, k.placements, v.placements, ppl, vrows),
        device_mesh=mesh, redistribute_inputs=True,
    )(whole(q), k, v, whole(k_pos), whole(kv_valid))


def _splits_rows_or_heads(q: Any, k: Any) -> bool:
    """Whether attention of ``q`` over ``k`` runs per rank: both on a mesh,
    the keys' sequence whole."""
    return is_dtensor(q) and is_dtensor(k) and not any(pl.is_shard(1) for pl in k.placements)


def _attend_on_mesh(fn, q, k, v, kv_valid: Optional[Any]):
    """``fn(q, k, v, kv_valid)`` (an attention over plain tensors, its
    positions and scalars bound) on ``DTensor`` q, k and v through
    ``local_map``, laid out as
    :func:`repro_torch.kernels.ops.flash_attention_bhsd` lays them out
    (:func:`~repro_torch.kernels.ops.mesh_heads`; ``kv_valid`` by batch
    rows): each rank attends its own rows and query heads over the whole
    key sequence of the KV heads they read.  (DTensor's own einsum views
    (B, Hk) as one dimension, which torch 2.11 refuses with the heads
    split.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    heads = ops.mesh_heads(q, k.shape[2])
    rows = [pl if pl == Shard(0) else Replicate() for pl in heads.q]
    if kv_valid is not None and not is_dtensor(kv_valid):
        kv_valid = DTensor.from_local(kv_valid, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def attend(a, b, c, valid):
        if heads.narrow is not None:
            b, c = (t.narrow(2, *heads.narrow) for t in (b, c))
        return fn(a, b, c, valid)

    vrows = None if kv_valid is None else rows
    return local_map(
        attend, out_placements=heads.q,
        in_placements=(heads.q, heads.kv, heads.kv, vrows),
        in_grad_placements=(heads.q, heads.kv_grad, heads.kv_grad, vrows),
        device_mesh=mesh, redistribute_inputs=True,
    )(q, k, v, kv_valid)


def attention_block(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    q_pos: torch.Tensor,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Full attention sub-layer: proj -> rope -> attend -> out-proj.

    Without a cache the sequence attends to itself causally through the
    flash kernel (positions are ``q_pos``, which every caller passes as
    ``arange(S)``: the kernel masks by index).  With ``kv_cache=(k, v)`` of
    shape (B, T, Hk, Dh) and ``cache_len`` (current fill) it writes the new
    K/V at slot ``cache_len % T`` **in place** (the reference returns an
    updated copy; the port saves the cache-sized copy) and attends over the
    filled prefix, or over the ring of a sliding-window cache: one token
    through :func:`attention_decode`, several through
    :func:`attention_chunked` with the config's ``attn_chunk``.  The
    several-token write starts at ``min(cache_len % T, T - S)``, where the
    reference's ``dynamic_update_slice`` clamps it, while the keys' validity
    and ring positions are taken from the unclamped slot and ``cache_len``,
    as there (so only keys up to position ``cache_len`` are valid).  On a
    mesh the write lands on each rank's shard of the cache, which keeps its
    layout (:func:`~repro_torch.sharding.utils.write_rows`).
    Returns (output, cache).
    """
    q = shard_act(torch.einsum("bsd,dhk->bshk", x, params["wq"]),
                  policy, "batch", None, "model", None)
    k, v = project_kv(params, x, q if kv_cache is None else None)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        t = ck.shape[1]
        s = q.shape[1]
        idx = int(cache_len) % t
        start = min(idx, t - s)
        write_rows(ck, 1, start, k.to(ck.dtype))
        write_rows(cv, 1, start, v.to(cv.dtype))
        new_cache = (ck, cv)
        k_pos_full = torch.arange(t, device=x.device)
        if cfg.sliding_window is not None and t <= cfg.sliding_window:
            # Ring buffer: absolute position of slot i.
            k_pos = cache_len - torch.remainder(idx - k_pos_full, t)
            kv_valid = (k_pos >= 0)[None, :].expand(x.shape[0], t)
            k_pos = torch.clamp(k_pos, min=0)
        else:
            k_pos = k_pos_full
            kv_valid = (k_pos_full <= cache_len)[None, :].expand(x.shape[0], t)
        if s == 1:
            out = attention_decode(
                q, ck, cv, k_pos, int(cache_len),
                window=cfg.sliding_window, kv_valid=kv_valid,
            )
        else:
            out = attention_chunked(
                q, ck, cv, q_pos, k_pos, window=cfg.sliding_window,
                causal=True, chunk=cfg.attn_chunk, kv_valid=kv_valid,
            )
    else:
        out = ops.flash_attention_bhsd(
            q, k, v, causal=True, window=cfg.sliding_window,
        )
    return out_proj(params, out, policy), new_cache


def out_proj(params: Params, out: torch.Tensor, policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    """The attention's output projection ``bshk,hkd->bsd``, row-parallel on
    a mesh (:func:`~repro_torch.sharding.utils.row_einsum`), its partial
    sum reduced to the residual stream's layout."""
    y = row_einsum("bshk,hkd->bsd", out, params["wo"], 2, 0)
    return shard_act(y, policy, "batch", None, None)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def init_mlp(
    generator: torch.Generator, cfg: ModelConfig, device: torch.device,
    d_ff: Optional[int] = None,
) -> Params:
    dtype = cfg.params_dtype()
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if cfg.activation == "swiglu":
        gate = dense_init(generator, d, (d_ff,), dtype, device)
        up = dense_init(generator, d, (d_ff,), dtype, device)
        return {
            "w_gu": torch.stack([gate, up], dim=1),  # (D, 2, F)
            "w_down": dense_init(generator, d_ff, (d,), dtype, device),
        }
    return {
        "w_up": dense_init(generator, d, (d_ff,), dtype, device),
        "w_down": dense_init(generator, d_ff, (d,), dtype, device),
    }


def spec_mlp(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    m, f = policy.physical("model"), policy.physical("fsdp")
    if cfg.activation == "swiglu":
        return {"w_gu": P(f, None, m), "w_down": P(m, f)}
    return {"w_up": P(f, m), "w_down": P(m, f)}


def mlp_block(params: Params, x: torch.Tensor, cfg: ModelConfig,
              policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    if cfg.activation == "swiglu":
        gu = column_einsum("bsd,dkf->bskf", x, params["w_gu"], 2, 3)
        g, u = gu[:, :, 0], gu[:, :, 1]
        h = F.silu(g.float()).to(u.dtype) * u
    else:
        h = x @ params["w_up"]
        if cfg.activation == "squared_relu":
            # Nemotron-4 (arXiv:2402.16819) uses squared ReLU.
            r = torch.relu(h)
            h = (r * r).to(h.dtype)
        elif cfg.activation == "gelu":
            # jax.nn.gelu defaults to the tanh approximation.
            h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
        else:
            raise ValueError(f"unknown activation {cfg.activation}")
    h = shard_act(h, policy, "batch", None, "model")
    return shard_act(h @ params["w_down"], policy, "batch", None, None)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embed(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    p = {"embedding": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                 cfg.params_dtype(), device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, (cfg.vocab_size,),
                                  cfg.params_dtype(), device)
    return p


def spec_embed(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    m, f = policy.physical("model"), policy.physical("fsdp")
    p = {"embedding": P(m, f)}
    if not cfg.tie_embeddings:
        p["unembed"] = P(f, m)
    return p


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    """The table cast to the activation dtype, then gathered (on a mesh per
    rank, :func:`_embed_on_mesh`)."""
    table = params["embedding"].to(cfg.activation_dtype())
    x = _embed_on_mesh(table, tokens) if is_dtensor(table) else table[tokens]
    return shard_act(x, policy, "batch", None, None)


def _embed_on_mesh(table: Any, tokens: Any) -> Any:
    """The rows of a ``DTensor`` table for ``tokens``, through ``local_map``.

    The vocabulary keeps its split where the tokens are whole (the rest of
    the table is gathered): each rank looks up the tokens of its own rows
    and leaves zeros elsewhere, so the result is a partial sum over the
    vocabulary shards — exactly one nonzero term per token — that the
    caller's ``shard_act`` reduces.  The table's gradient lands in its
    vocabulary shards, a partial sum over the batch shards.  (DTensor's
    own ``embedding`` rule, a masked partial, has no sound backward on a
    batch-sharded mesh.)
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokpl = (tokens.placements if isinstance(tokens, DTensor)
             else (Replicate(),) * mesh.ndim)
    # A mesh dim that splits the tokens' batch cannot split the vocabulary.
    tpl = [pl if pl == Shard(0) and not k.is_shard() else Replicate()
           for pl, k in zip(table.placements, tokpl)]
    off, n = local_extent(table.shape, tpl, mesh)[0]
    out = [Partial() if t.is_shard() else k for t, k in zip(tpl, tokpl)]
    grad = [t if t.is_shard() else (Partial() if k.is_shard() else Replicate())
            for t, k in zip(tpl, tokpl)]

    def lookup(tab: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        local = tok - off
        hit = ((local >= 0) & (local < n))[..., None]
        rows = tab[local.clamp(0, n - 1)]
        return torch.where(hit, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))

    return local_map(
        lookup, out_placements=out, in_placements=(tpl, tokpl),
        in_grad_placements=(grad, tokpl), device_mesh=mesh, redistribute_inputs=True,
    )(table, tokens)


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
            policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    params = gather_fsdp(params, policy)
    w = (
        params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    ).to(cfg.activation_dtype())
    return shard_act(x @ w, policy, "batch", None, "model")
