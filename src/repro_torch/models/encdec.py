"""Whisper-style encoder-decoder, the `encdec` family (arXiv:2212.04356): the
PyTorch port of ``repro.models.encdec``.

As in the reference, the modality frontend is a stub: callers deliver
precomputed frame features ``(B, T_enc, enc_inputs)``, and a linear
projection plus sinusoidal positions stand in for Whisper's two conv
layers.  The bidirectional encoder, the causal decoder with
cross-attention, prefill and single-token decode with self-KV and cross-KV
caches are whole.  Absolute sinusoidal positions (no RoPE), GELU MLPs and
RMSNorm, as there.

Every full-sequence attention goes through the flash kernel on CUDA:
non-causal in the encoder and the cross-attention, causal in the decoder's
self-attention.  One decode token attends through the plain
:func:`~repro_torch.models.layers.attention_decode` (self, masked by the
cache fill) and :func:`~repro_torch.models.layers.attention_dense` (cross),
as the reference does.

**The reference's padded keys.**  Its chunked attention
(``repro/models/layers.py::attention_chunked``) zero-pads K and V up to a
multiple of the chunk and masks the pad only under ``causal`` or
``kv_valid``; a non-causal call without ``kv_valid`` lets the zero keys
into the softmax's denominator.  The reference takes that path in every
encoder and cross-attention of ``encode`` and ``forward``, and in
``prefill`` and ``decode_step`` wherever the keys outnumber the chunk.  The
port is held to the reference, so :func:`reference_keys` pads the same keys
at the same call sites and the kernel attends over them as real keys
(whisper-medium: 1500 encoder frames, chunk 1024, 548 zero keys).

The entry points take the reference's sharding ``policy`` last
(``TP_POLICY`` by default); on a mesh the features and token ids are
placed batch-sharded and the stacks run on ``DTensor``s with the
reference's ``shard_act`` sites, the cache keeping ``encdec_cache_spec``'s
layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.cache import (
    EncDecCache, encdec_cache_shape, encdec_cache_spec, prefill_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    draw_stacked, layer_params, num_stacked, stacked_specs, token_ids,
)
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import (
    gather_fsdp, mesh_of, mesh_pad, on_mesh, place_batch, write_rows,
)

Params = Dict[str, Any]


def _sinusoid_rows(positions: torch.Tensor, channels: int) -> torch.Tensor:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(
        -log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=positions.device)
    )
    scaled = positions.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def sinusoids(length: int, channels: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """Whisper's sinusoidal position table (length, channels), fp32."""
    return _sinusoid_rows(torch.arange(length, device=device), channels)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _init_enc_layer(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = cfg.params_dtype()
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": L.init_attention(generator, cfg, device),
        "mlp": L.init_mlp(generator, cfg, device),
    }


def _init_dec_layer(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    dtype = cfg.params_dtype()
    return {
        "self_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "cross_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "self_attn": L.init_attention(generator, cfg, device),
        "cross_attn": L.init_attention(generator, cfg, device),
        "mlp": L.init_mlp(generator, cfg, device),
    }


def init(generator: torch.Generator, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """Parameters on ``device`` (``cuda`` unless the caller names another),
    drawn from ``generator``, in the reference's layout (encoder and
    decoder layers stacked with a leading L axis)."""
    if cfg.family != "encdec":
        raise ValueError(f"encdec.init takes an encdec config, not {cfg.family!r}")
    dev = resolve_device(device)
    dtype = cfg.params_dtype()
    return {
        "frontend_proj": L.dense_init(generator, cfg.enc_inputs, (cfg.d_model,), dtype, dev),
        "embed": L.init_embed(generator, cfg, dev),
        "enc_layers": draw_stacked(lambda: _init_enc_layer(generator, cfg, dev), cfg.enc_layers),
        "dec_layers": draw_stacked(lambda: _init_dec_layer(generator, cfg, dev), cfg.num_layers),
        "enc_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    enc = {
        "attn_norm": L.spec_rmsnorm(),
        "mlp_norm": L.spec_rmsnorm(),
        "attn": L.spec_attention(policy),
        "mlp": L.spec_mlp(cfg, policy),
    }
    dec = {
        "self_norm": L.spec_rmsnorm(),
        "cross_norm": L.spec_rmsnorm(),
        "mlp_norm": L.spec_rmsnorm(),
        "self_attn": L.spec_attention(policy),
        "cross_attn": L.spec_attention(policy),
        "mlp": L.spec_mlp(cfg, policy),
    }
    return {
        "frontend_proj": P(None, policy.physical("model")),
        "embed": L.spec_embed(cfg, policy),
        "enc_layers": stacked_specs(enc),
        "dec_layers": stacked_specs(dec),
        "enc_norm": L.spec_rmsnorm(),
        "final_norm": L.spec_rmsnorm(),
    }


# --------------------------------------------------------------------------
# Attention without RoPE (Whisper uses absolute positions)
# --------------------------------------------------------------------------

def reference_keys(
    k: torch.Tensor, v: torch.Tensor, chunk: int, chunked: bool, causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K and V (B, T, Hk, Dh) as the reference's attention sees them.

    Where the reference takes its chunked path (``chunked``) without the
    causal mask, and T is not a multiple of ``chunk``, it attends over T
    rounded up to the chunk, the added keys and values zero: so do these.
    Elsewhere the reference masks its pad (as it does under ``kv_valid``,
    which only the self-attention of a decode step passes), and K and V
    come back as they are."""
    t = k.shape[1]
    if not chunked or causal or t % chunk == 0:
        return k, v
    pad = (0, 0, 0, 0, 0, chunk - t % chunk)
    return mesh_pad(k, pad), mesh_pad(v, pad)


def _attend(
    ap: Params, xq: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig, causal: bool,
    chunked: bool, policy: ShardingPolicy,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention of ``xq`` over the K/V of ``xkv`` through the flash kernel;
    the reference's chunked path where ``chunked``, its dense one
    elsewhere.  Returns the projected output and (K, V) as the attention
    read them (on a mesh, :func:`~repro_torch.models.layers.project_kv`'s
    layout: :func:`~repro_torch.models.layers.collapse_heads` gives a
    cache's heads)."""
    q = shard_act(torch.einsum("bsd,dhk->bshk", xq, ap["wq"]),
                  policy, "batch", None, "model", None)
    k, v = L.project_kv(ap, xkv, q)
    kp, vp = reference_keys(k, v, cfg.attn_chunk, chunked, causal)
    out = ops.flash_attention_bhsd(q, kp, vp, causal=causal)
    return L.out_proj(ap, out, policy), (k, v)


# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

def _device(params: Params) -> torch.device:
    return params["embed"]["embedding"].device


def encode(params: Params, features: Any, cfg: ModelConfig,
           policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    """Encoder output (B, T_enc, D) from frontend features (B, T_enc,
    enc_inputs)."""
    with on_mesh(params):
        features = torch.as_tensor(features, device=_device(params))
        mesh = mesh_of(params["frontend_proj"])
        if mesh is not None:
            features = place_batch(features, policy, mesh)
        t = features.shape[1]
        x = features.to(cfg.activation_dtype()) @ params["frontend_proj"]
        x = x + sinusoids(t, cfg.d_model, x.device).to(x.dtype)[None]
        x = shard_act(x, policy, "batch", None, None)

        def body(lp: Params, x: torch.Tensor) -> torch.Tensor:
            lp = gather_fsdp(lp, policy)
            h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
            x = x + _attend(lp["attn"], h, h, cfg, causal=False, chunked=True, policy=policy)[0]
            h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
            return shard_act(x + L.mlp_block(lp["mlp"], h, cfg, policy),
                             policy, "batch", None, None)

        for i in range(num_stacked(params["enc_layers"])):
            x = L.remat(cfg, body, layer_params(params["enc_layers"], i), x)
        return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# --------------------------------------------------------------------------
# Decoder (teacher-forced / prefill / decode)
# --------------------------------------------------------------------------

def _decoder_input(params: Params, tokens: Any, cfg: ModelConfig,
                   policy: ShardingPolicy) -> torch.Tensor:
    tokens = token_ids(tokens, params, policy)
    x = L.embed_tokens(params["embed"], tokens, cfg, policy)
    return x + sinusoids(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)[None]


def _decoder(
    params: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig, cached: bool,
    policy: ShardingPolicy,
) -> Tuple[torch.Tensor, Optional[EncDecCache]]:
    """The decoder stack over a full sequence.  ``cached`` (prefill) takes
    the reference's ``_attend_cached`` paths (chunked only where the keys
    outnumber the chunk) and returns the caches; otherwise (``forward``)
    every attention takes its chunked path.  The caches are allocated once
    (on a mesh in ``encdec_cache_spec``'s layout) and each attention's K/V
    written into its layer's slots as soon as it has attended."""
    layers = params["dec_layers"]
    cache = None
    if cached:
        (b, s), t_enc = x.shape[:2], enc_out.shape[1]
        cache = prefill_cache(encdec_cache_shape(cfg, b, s, t_enc, num_stacked(layers)),
                              encdec_cache_spec(cfg, policy), mesh_of(params), x.device)

    def attend(i: int, ap: Params, h: torch.Tensor, kv_in: torch.Tensor,
               causal: bool) -> torch.Tensor:
        chunked = kv_in.shape[1] > cfg.attn_chunk or not cached
        y, kv = _attend(ap, h, kv_in, cfg, causal=causal, chunked=chunked, policy=policy)
        if cached:
            bufs = ((cache.self_kv.k, cache.self_kv.v) if causal
                    else (cache.cross_k, cache.cross_v))
            for buf, t in zip(bufs, kv):
                L.write_cache_layer(buf, i, t, cfg.n_kv_heads)
        return y

    def body(lp: Params, x: torch.Tensor, enc_out: torch.Tensor, i: int) -> torch.Tensor:
        lp = gather_fsdp(lp, policy)
        h = L.rmsnorm(lp["self_norm"], x, cfg.norm_eps)
        x = x + attend(i, lp["self_attn"], h, h, causal=True)
        h = L.rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
        x = x + attend(i, lp["cross_attn"], h, enc_out, causal=False)
        h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        x = x + L.mlp_block(lp["mlp"], h, cfg, policy)
        return shard_act(x, policy, "batch", None, None)

    for i in range(num_stacked(layers)):
        x = L.remat(cfg, body, layer_params(layers, i), x, enc_out, i)
    return x, cache


def forward(
    params: Params, features: Any, tokens: Any, cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass -> (logits (B, S, V), aux = 0)."""
    with on_mesh(params):
        enc_out = encode(params, features, cfg, policy)
        x, _ = _decoder(params, _decoder_input(params, tokens, cfg, policy), enc_out, cfg,
                        cached=False, policy=policy)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return L.unembed(params["embed"], x, cfg, policy), aux


def prefill(
    params: Params, features: Any, tokens: Any, cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, EncDecCache]:
    """Encode the audio and consume the decoder prompt: last-position logits
    (B, V) and the caches (self K/V of the prompt, cross K/V of the
    encoder output, each (L, B, T, Hk, Dh))."""
    with on_mesh(params):
        enc_out = encode(params, features, cfg, policy)
        x, cache = _decoder(params, _decoder_input(params, tokens, cfg, policy), enc_out, cfg,
                            cached=True, policy=policy)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg, policy)[:, 0], cache


def decode_step(
    params: Params, token: Any, cache: EncDecCache, cache_len: int, cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, EncDecCache]:
    """One decode step: logits (B, V) for the next position + the cache.

    The token's self K/V are written into ``cache.self_kv`` in place at
    slot ``cache_len`` of every layer (no ring: Whisper has no window), and
    ``cache`` itself is returned; the reference returns an updated copy."""
    with on_mesh(params):
        token = token_ids(token, params, policy)
        cache_len = int(cache_len)
        x = L.embed_tokens(params["embed"], token[:, None], cfg, policy)  # (B, 1, D)
        pos = torch.full((1,), cache_len, device=x.device)
        x = x + _sinusoid_rows(pos, cfg.d_model).to(x.dtype)[None]
        b = x.shape[0]
        t_self = cache.self_kv.capacity
        kpos = torch.arange(t_self, device=x.device)
        valid = (kpos <= cache_len)[None, :].expand(b, t_self)
        epos = torch.arange(cache.cross_k.shape[2], device=x.device)
        for i in range(num_stacked(params["dec_layers"])):
            lp = gather_fsdp(layer_params(params["dec_layers"], i), policy)
            h = L.rmsnorm(lp["self_norm"], x, cfg.norm_eps)
            nk, nv = L.project_kv(lp["self_attn"], h)
            sk, sv = cache.self_kv.k[i], cache.self_kv.v[i]
            write_rows(sk, 1, cache_len, nk.to(sk.dtype))
            write_rows(sv, 1, cache_len, nv.to(sv.dtype))
            q = torch.einsum("bsd,dhk->bshk", h, lp["self_attn"]["wq"])
            out = L.attention_decode(q, sk, sv, kpos, cache_len, kv_valid=valid)
            x = x + L.out_proj(lp["self_attn"], out, policy)

            h = L.rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
            q = torch.einsum("bsd,dhk->bshk", h, lp["cross_attn"]["wq"])
            ck, cv = reference_keys(cache.cross_k[i], cache.cross_v[i], cfg.attn_chunk,
                                    chunked=epos.shape[0] > cfg.attn_chunk, causal=False)
            out = L.attention_dense(q, ck, cv, pos, epos, causal=False)
            x = x + L.out_proj(lp["cross_attn"], out, policy)

            h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
            x = x + L.mlp_block(lp["mlp"], h, cfg, policy)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg, policy)[:, 0], cache
