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

The reference's sharding ``policy`` arguments are no-ops on one device and
are dropped.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

NEG_INF = -1e30


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
    """
    shape = (in_dim, *out_shape)
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (1.0 / math.sqrt(in_dim))).to(device=device, dtype=dtype)


def embed_init(
    generator: torch.Generator, vocab: int, dim: int, dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    t = torch.empty((vocab, dim), device=generator.device)
    t.normal_(0.0, 1.0, generator=generator)
    return (t * 0.02).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


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


def project_kv(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kv = torch.einsum("bsd,dthk->bsthk", x, params["w_kv"])
    return kv[:, :, 0], kv[:, :, 1]


def _causal_window_mask(
    q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]
) -> torch.Tensor:
    """(..., S, T) True where attention is allowed."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        mask &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return mask


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
    """Reference attention: full score matrix.  q: (B,S,Hq,Dh); k/v: (B,T,Hk,Dh)."""
    b, s, hq, dh = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, s, hk, g, dh)
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
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=torch.iinfo(torch.int32).max)
        if kv_valid is not None:
            kv_valid = F.pad(kv_valid, (0, pad), value=False)
        t = k.shape[1]
    n_chunks = t // chunk
    qg = q.reshape(b, s, hk, g, dh).float() / math.sqrt(dh)
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
    softmax weights are rounded to V's dtype first, as there.
    """
    b, s, hq, dh = q.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one query token, got {s}")
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, hk, g, dh)
    scores = torch.einsum("bhgd,bthd->bhgt", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    mask = k_pos[None, None, None, :] <= q_pos_scalar
    if window is not None:
        mask = mask & ((q_pos_scalar - k_pos[None, None, None, :]) < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    w = torch.softmax(_masked(scores, mask), dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def attention_block(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    q_pos: torch.Tensor,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
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
    as there (so only keys up to position ``cache_len`` are valid).
    Returns (output, cache).
    """
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k, v = project_kv(params, x)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        t = ck.shape[1]
        s = q.shape[1]
        idx = int(cache_len) % t
        start = min(idx, t - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
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
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


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


def mlp_block(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "swiglu":
        gu = torch.einsum("bsd,dkf->bskf", x, params["w_gu"])
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
    return h @ params["w_down"]


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


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The table cast to the activation dtype, then gathered."""
    return params["embedding"].to(cfg.activation_dtype())[tokens]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = (
        params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    ).to(cfg.activation_dtype())
    return x @ w
