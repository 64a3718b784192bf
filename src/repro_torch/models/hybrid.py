"""Zamba2-style hybrid: Mamba2 backbone + a globally-shared attention block
(arXiv:2411.15242), the PyTorch port of ``repro.models.hybrid``.

Zamba2 interleaves Mamba2 blocks with a *single* shared full-attention block
invoked every ``hybrid_attn_period`` layers; invocations differ through
cheap per-invocation input norms AND low-rank (LoRA) deltas on the shared
block's q/kv projections (``hybrid_lora_rank``).

Structure (for ``num_layers = P * n_inv``)::

    for i in range(n_inv):            # super-blocks
        for j in range(P):            # Mamba2 layers
            x += mamba2(x)
        h = norm_i(x)                 # shared weights, per-invocation norm
        x += shared_attn(h) + shared_mlp(h)

Full sequences (``forward``, ``prefill``) run each Mamba2 SSD through the
SSD kernel and the shared attention through the flash kernel on CUDA (the
plain versions on the CPU), where the reference calls its jnp oracles.
Decode uses :class:`~repro_torch.models.cache.HybridCache` — SSM state for
every Mamba2 layer and a KV cache per shared-attention invocation — and
updates it in place.  Mamba2 parameters are stacked (n_inv, period, ...),
as in the reference, and looped where the reference scans.  The entry
points take the reference's sharding ``policy`` last (``TP_POLICY`` by
default); on a mesh they run on ``DTensor``s as ``models.ssm`` and
``models.transformer`` do, the cache keeping ``hybrid_cache_spec``'s
layout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as M
from repro_torch.models.cache import HybridCache, KVCache, SSMCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import draw_stacked, layer_params, stacked_specs, token_ids
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import column_einsum, gather_fsdp, on_mesh, write_rows

Params = Dict[str, Any]


def _n_inv(cfg: ModelConfig) -> int:
    if cfg.family != "hybrid":
        raise ValueError(f"models.hybrid runs the hybrid family, not {cfg.family!r}")
    if cfg.num_layers % cfg.hybrid_attn_period != 0:
        raise ValueError("hybrid depth must be a multiple of hybrid_attn_period")
    return cfg.num_layers // cfg.hybrid_attn_period


def init(generator: torch.Generator, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """Parameters on ``device`` (``cuda`` unless the caller names another),
    drawn from ``generator``, in the reference's layout."""
    n_inv, period = _n_inv(cfg), cfg.hybrid_attn_period
    dev = resolve_device(device)
    dtype = cfg.params_dtype()
    params = {
        "embed": L.init_embed(generator, cfg, dev),
        "mamba": draw_stacked(   # leaves: (n_inv, period, ...)
            lambda: draw_stacked(lambda: M.init_mamba_block(generator, cfg, dev), period),
            n_inv,
        ),
        "shared_attn": L.init_attention(generator, cfg, dev),   # ONE set of weights
        "shared_mlp": L.init_mlp(generator, cfg, dev),
        "inv_norms": {"scale": torch.ones((n_inv, cfg.d_model), dtype=dtype, device=dev)},
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if cfg.hybrid_lora_rank > 0:
        # Zamba2's per-invocation LoRA deltas on the shared block's q/kv
        # projections: A fan-in normal, B zero (invocation 0 == the shared
        # weights exactly until B is trained).
        r = cfg.hybrid_lora_rank
        d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def lora_a():
            return torch.stack([L.dense_init(generator, d, (r,), dtype, dev) for _ in range(n_inv)])

        params["inv_lora"] = {
            "aq": lora_a(),                                                  # (n_inv, D, r)
            "bq": torch.zeros((n_inv, r, hq, hd), dtype=dtype, device=dev),
            "akv": lora_a(),
            "bkv": torch.zeros((n_inv, r, 2, hk, hd), dtype=dtype, device=dev),
        }
    return params


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    specs = {
        "embed": L.spec_embed(cfg, policy),
        "mamba": stacked_specs(M.spec_mamba_block(cfg, policy), depth=2),
        "shared_attn": L.spec_attention(policy),
        "shared_mlp": L.spec_mlp(cfg, policy),
        "inv_norms": stacked_specs(L.spec_rmsnorm()),
    }
    if cfg.hybrid_lora_rank > 0:
        specs["inv_lora"] = {
            "aq": P(None, None, None),
            "bq": P(None, None, policy.physical("model"), None),
            "akv": P(None, None, None),
            "bkv": P(None, None, None, None, None),
        }
    specs["final_norm"] = L.spec_rmsnorm()
    return specs


def _lora_qkv(params: Params, inv_lora: Optional[Params], h: torch.Tensor,
              policy: ShardingPolicy, attend: bool):
    """Shared-weight q/k/v projections + per-invocation LoRA deltas.  With
    ``attend`` (a full-sequence attention) K and V come back laid out for
    it (:func:`~repro_torch.models.layers.project_kv`)."""
    ap = params["shared_attn"]
    q = torch.einsum("bsd,dhk->bshk", h, ap["wq"])
    if inv_lora is not None:
        zq = h @ inv_lora["aq"]                                  # (B,S,r)
        q = q + torch.einsum("bsr,rhk->bshk", zq, inv_lora["bq"])
    q = shard_act(q, policy, "batch", None, "model", None)
    k, v = L.project_kv(ap, h, q if attend else None)
    if inv_lora is not None:
        zkv = h @ inv_lora["akv"]
        dkv = column_einsum("bsr,rthk->bsthk", zkv, inv_lora["bkv"], 2, 3)
        if attend:
            dkv = L.expand_heads(dkv, 3, q)
        k = k + dkv[:, :, 0]
        v = v + dkv[:, :, 1]
    return q, k, v


def _invocation(params: Params, i: int) -> Tuple[Params, Optional[Params]]:
    """Invocation ``i``'s input norm and LoRA deltas (None without LoRA)."""
    lora = params.get("inv_lora")
    return layer_params(params["inv_norms"], i), (
        layer_params(lora, i) if lora is not None else None
    )


def _shared_attn_apply(
    params: Params,
    inv_norm: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    q_pos: torch.Tensor,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
    inv_lora: Optional[Params] = None,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The shared attention and MLP on one normed ``h``, both added to ``x``.

    Without ``kv`` the sequence attends to itself causally through
    :func:`repro_torch.kernels.ops.flash_attention_bhsd`, and the roped K and
    raw V come back for the cache.  With ``kv=(k, v)`` of shape
    (B, T, Hk, Dh) one token decodes: its K/V are written **in place** at slot
    ``cache_len % T`` and it attends over slots ``<= cache_len`` (no ring
    handling, as in the reference).
    """
    params = gather_fsdp({k: params[k] for k in ("shared_attn", "shared_mlp")}, policy)
    h = L.rmsnorm(inv_norm, x, cfg.norm_eps)
    ap = params["shared_attn"]
    q, k_new, v_new = _lora_qkv(params, inv_lora, h, policy, attend=kv is None)
    q = L.apply_rope(q, q_pos, cfg.rope_theta)
    k_new = L.apply_rope(k_new, q_pos, cfg.rope_theta)
    if kv is not None:
        ck, cv = kv
        t = ck.shape[1]
        idx = int(cache_len) % t
        write_rows(ck, 1, idx, k_new.to(ck.dtype))
        write_rows(cv, 1, idx, v_new.to(cv.dtype))
        k_pos = torch.arange(t, device=x.device)
        kv_valid = (k_pos <= cache_len)[None, :].expand(x.shape[0], t)
        attn = L.attention_decode(
            q, ck, cv, k_pos, int(cache_len), window=cfg.sliding_window, kv_valid=kv_valid,
        )
        new_kv = (ck, cv)
    else:
        attn = ops.flash_attention_bhsd(q, k_new, v_new, causal=True, window=cfg.sliding_window)
        new_kv = tuple(L.collapse_heads(t, cfg.n_kv_heads) for t in (k_new, v_new))
    x = x + L.out_proj(ap, attn, policy)
    x = x + L.mlp_block(params["shared_mlp"], h, cfg, policy)
    return shard_act(x, policy, "batch", None, None), new_kv


def _mamba(params: Params, i: int, j: int) -> Params:
    return layer_params(layer_params(params["mamba"], i), j)


def forward(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, V) and a zero aux loss."""
    n_inv, period = _n_inv(cfg), cfg.hybrid_attn_period
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        q_pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)

        def inner(lp: Params, x: torch.Tensor) -> torch.Tensor:
            y, _ = M.mamba_block(lp, x, cfg, policy=policy)
            return x + y

        for i in range(n_inv):
            for j in range(period):
                x = L.remat(cfg, inner, _mamba(params, i, j), x)
            inv_norm, inv_lora = _invocation(params, i)
            x, _ = _shared_attn_apply(params, inv_norm, x, cfg, q_pos, inv_lora=inv_lora,
                                      policy=policy)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, HybridCache]:
    """Prompt pass: last-position logits + the SSM caches of every Mamba2
    layer and the roped K / raw V of every shared-attention invocation."""
    n_inv, period = _n_inv(cfg), cfg.hybrid_attn_period
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        q_pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
        tails, states, ks, vs = [], [], [], []
        for i in range(n_inv):
            for j in range(period):
                y, tail, final = M.mamba_sequence(_mamba(params, i, j), x, cfg, policy)
                x = x + y
                tails.append(tail)
                states.append(final)
            inv_norm, inv_lora = _invocation(params, i)
            x, (k, v) = _shared_attn_apply(params, inv_norm, x, cfg, q_pos,
                                           inv_lora=inv_lora, policy=policy)
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        cache = HybridCache(
            ssm=SSMCache(conv=torch.stack(tails), state=torch.stack(states)),
            kv=KVCache(k=torch.stack(ks), v=torch.stack(vs)),
        )
        return logits[:, 0], cache


def decode_step(
    params: Params,
    token: Any,                 # (B,) newest token ids
    cache: HybridCache,
    cache_len: int,             # number of tokens already cached
    cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, HybridCache]:
    """One decode step: logits (B, V) + the cache, updated **in place** (every
    Mamba2 layer's conv window and state, every invocation's K/V slot
    ``cache_len % T``) and returned — the reference returns an updated copy."""
    n_inv, period = _n_inv(cfg), cfg.hybrid_attn_period
    with on_mesh(params):
        token = token_ids(token, params, policy)
        x = L.embed_tokens(params["embed"], token[:, None], cfg, policy)
        q_pos = torch.full((1,), int(cache_len), dtype=torch.int32, device=x.device)
        for i in range(n_inv):
            for j in range(period):
                layer = i * period + j
                y, (conv, state) = M.mamba_block(
                    _mamba(params, i, j), x, cfg,
                    cache=(cache.ssm.conv[layer], cache.ssm.state[layer]), policy=policy,
                )
                write_rows(cache.ssm.conv, 0, layer, conv[None])
                write_rows(cache.ssm.state, 0, layer, state[None])
                x = x + y
            inv_norm, inv_lora = _invocation(params, i)
            x, _ = _shared_attn_apply(
                params, inv_norm, x, cfg, q_pos,
                kv=(cache.kv.k[i], cache.kv.v[i]), cache_len=cache_len, inv_lora=inv_lora,
                policy=policy,
            )
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits[:, 0], cache
