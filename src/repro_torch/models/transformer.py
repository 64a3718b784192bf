"""Decoder-only transformer covering the dense, MoE and VLM families: the
PyTorch port of ``repro.models.transformer``.

* **dense**: granite-34b/20b (MQA), nemotron-4-340b (GQA + squared-ReLU),
  mistral-nemo-12b (GQA);
* **moe**: mixtral-8x22b (8 experts top-2 + sliding window),
  qwen2-moe-a2.7b (4 shared + 60 routed top-4): the MLP is
  :func:`repro_torch.models.moe.moe_mlp`;
* **vlm**: chameleon-34b, whose early fusion puts image content in the
  token vocabulary, so its backbone is exactly the dense decoder.

Layer parameters stay stacked with a leading L axis, as in the reference,
so its trees carry over unchanged; the port loops over the layers where the
reference scans.  Every full-sequence attention (``forward``,
``hidden_states``, ``prefill``) goes through the flash kernel on CUDA.

Entry points (plain functions; the device is the parameters'; each takes
the sharding ``policy`` last, ``TP_POLICY`` by default):
  ``init`` / ``param_specs`` — parameters from a ``torch.Generator`` and
  their spec tree (the stacked layer axis replicated).
  ``forward`` — full-sequence logits.
  ``hidden_states`` — hidden states after some layers (affinity profiling).
  ``prefill`` — forward + populated KV cache + last-position logits.
  ``decode_step`` — one token against a KV cache.

On a mesh (parameters placed by ``fit_specs(params, param_specs(policy),
mesh)``) the token ids are placed batch-sharded, the body runs on
``DTensor``s under ``implicit_replication`` with the reference's
``shard_act`` constraints, and a decode step writes each layer's K/V on
the local shards of the cache, which keeps ``cache_specs``' layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.cache import KVCache, kv_cache_shape, kv_cache_spec, prefill_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import init_moe_mlp, moe_mlp, spec_moe_mlp
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import gather_fsdp, mesh_of, on_mesh, place_batch

Params = Dict[str, Any]


FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"the decoder runs the {FAMILIES} families, not {cfg.family!r}")


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of a stacked layer tree (views, no copy)."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def num_stacked(layers: Params) -> int:
    """The leading L axis of a stacked layer tree."""
    while isinstance(layers, dict):
        layers = next(iter(layers.values()))
    return layers.shape[0]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    _check_family(cfg)
    p: Params = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, cfg.params_dtype(), device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, cfg.params_dtype(), device),
        "attn": L.init_attention(generator, cfg, device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe_mlp(generator, cfg, device)
    else:
        p["mlp"] = L.init_mlp(generator, cfg, device)
    return p


def _stacked_like(tree: Params, n: int) -> Params:
    """Uninitialised tensors of ``tree``'s layout with a leading axis of ``n``."""
    if isinstance(tree, dict):
        return {k: _stacked_like(v, n) for k, v in tree.items()}
    return tree.new_empty((n, *tree.shape))


def _write(stacked: Params, i: int, tree: Params) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _write(stacked[k], i, v)
    else:
        stacked[i].copy_(tree)


def draw_stacked(draw: Callable[[], Params], n: int) -> Params:
    """``n`` calls of ``draw`` in order, stacked on a new leading axis.  Each
    draw is written into the preallocated stack as it comes, so the peak is
    the stack plus one draw, not two copies of the weights."""
    first = draw()
    stacked = _stacked_like(first, n)
    _write(stacked, 0, first)
    del first
    for i in range(1, n):
        _write(stacked, i, draw())
    return stacked


def init_layers(
    generator: torch.Generator, cfg: ModelConfig, n: int, device: torch.device
) -> Params:
    """``n`` layers drawn in order, stacked with a leading L axis."""
    return draw_stacked(lambda: _init_layer(generator, cfg, device), n)


def init(
    generator: torch.Generator, cfg: ModelConfig, device: DeviceLike = None
) -> Params:
    """Parameters of the whole model on ``device`` (``cuda`` unless the
    caller names another), drawn from ``generator``."""
    _check_family(cfg)
    dev = resolve_device(device)
    return {
        "embed": L.init_embed(generator, cfg, dev),
        "layers": init_layers(generator, cfg, cfg.num_layers, dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.params_dtype(), dev),
    }


def stacked_specs(tree: Params, depth: int = 1) -> Params:
    """A spec tree with ``depth`` replicated leading axes (stacked layers)."""
    if isinstance(tree, dict):
        return {k: stacked_specs(v, depth) for k, v in tree.items()}
    return P(*([None] * depth), *tuple(tree))


def _spec_layer(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    p: Params = {
        "attn_norm": L.spec_rmsnorm(),
        "mlp_norm": L.spec_rmsnorm(),
        "attn": L.spec_attention(policy),
    }
    if cfg.family == "moe":
        p["moe"] = spec_moe_mlp(cfg, policy)
    else:
        p["mlp"] = L.spec_mlp(cfg, policy)
    return p


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    return {
        "embed": L.spec_embed(cfg, policy),
        "layers": stacked_specs(_spec_layer(cfg, policy)),
        "final_norm": L.spec_rmsnorm(),
    }


def cache_specs(cfg: ModelConfig, policy: ShardingPolicy) -> KVCache:
    return kv_cache_spec(cfg, policy)


# --------------------------------------------------------------------------
# Layer body
# --------------------------------------------------------------------------

def _layer_apply(
    lp: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    q_pos: torch.Tensor,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[int] = None,
    return_kv: bool = False,
    policy: ShardingPolicy = TP_POLICY,
):
    """One pre-norm decoder layer.  Returns (x, new_kv, aux): with
    ``return_kv`` (prefill) the fresh K/V for the cache, as the attention
    read them (on a mesh :func:`~repro_torch.models.layers.project_kv`'s
    layout, which :func:`~repro_torch.models.layers.write_cache_layer`
    takes), with ``kv`` the cache written in place by the decode token."""
    _check_family(cfg)
    lp = gather_fsdp(lp, policy)
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    if return_kv:
        # Prefill: compute fresh K/V and also hand them back for the cache.
        q = shard_act(torch.einsum("bsd,dhk->bshk", h, lp["attn"]["wq"]),
                      policy, "batch", None, "model", None)
        k, v = L.project_kv(lp["attn"], h, q)
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
        attn_out = ops.flash_attention_bhsd(
            q, k, v, causal=True, window=cfg.sliding_window
        )
        attn_out = L.out_proj(lp["attn"], attn_out, policy)
        new_kv = (k, v)
    else:
        attn_out, new_kv = L.attention_block(
            lp["attn"], h, cfg, q_pos, kv_cache=kv, cache_len=cache_len, policy=policy,
        )
    x = x + attn_out
    h = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.family == "moe":
        mlp_out, aux = moe_mlp(lp["moe"], h, cfg, policy)
    else:
        mlp_out = L.mlp_block(lp["mlp"], h, cfg, policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return shard_act(x + mlp_out, policy, "batch", None, None), new_kv, aux


def _positions(s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)


def token_ids(tokens: Any, params: Params, policy: ShardingPolicy = TP_POLICY) -> torch.Tensor:
    """Token ids as a long tensor on the parameters' device; on a mesh
    placed batch-sharded (:func:`~repro_torch.sharding.utils.place_batch`)."""
    table = params["embed"]["embedding"]
    ids = torch.as_tensor(tokens, device=table.device).long()
    mesh = mesh_of(table)
    return ids if mesh is None else place_batch(ids, policy, mesh)


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def forward(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, V) and the summed MoE aux loss (0
    outside the MoE family)."""
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        q_pos = _positions(tokens.shape[1], x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(lp: Params, x: torch.Tensor):
            x, _, a = _layer_apply(lp, x, cfg, q_pos, policy=policy)
            return x, a

        for i in range(num_stacked(params["layers"])):
            x, a = L.remat(cfg, body, layer_params(params["layers"], i), x)
            aux = aux + a
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg, policy), aux


def hidden_states(
    params: Params, tokens: Any, cfg: ModelConfig, upto_layer: Optional[int] = None,
    policy: ShardingPolicy = TP_POLICY,
) -> torch.Tensor:
    """Hidden states after ``upto_layer`` layers (for affinity profiling)."""
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        q_pos = _positions(tokens.shape[1], x.device)
        n = upto_layer if upto_layer is not None else cfg.num_layers
        for i in range(n):
            x, _, _ = _layer_apply(layer_params(params["layers"], i), x, cfg, q_pos,
                                   policy=policy)
        return x


def prefill(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, KVCache]:
    """Process a full prompt; return last-position logits + KV cache.

    The cache is allocated once, on a mesh in ``kv_cache_spec``'s layout,
    and each layer's K/V are written into it as the layer finishes.
    Sliding-window configs keep only the trailing window, laid out as a
    ring buffer (slot = position % window) to match ``decode_step``."""
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        b, s = tokens.shape
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        q_pos = _positions(s, x.device)
        n = num_stacked(params["layers"])
        cache = prefill_cache(kv_cache_shape(cfg, b, s, n), kv_cache_spec(cfg, policy),
                              mesh_of(params), x.device)
        w = cfg.sliding_window
        ring = w is not None and s > w

        def body(lp: Params, x: torch.Tensor):
            x, kv, _ = _layer_apply(lp, x, cfg, q_pos, return_kv=True, policy=policy)
            return x, kv

        for i in range(n):
            x, kv = L.remat(cfg, body, layer_params(params["layers"], i), x)
            for buf, t in zip((cache.k, cache.v), kv):
                # The attention holds the sequence whole: the window is a local slice.
                L.write_cache_layer(buf, i, t[:, s - w:] if ring else t, cfg.n_kv_heads,
                                    s % w if ring else 0)
            del kv, t  # else they live on through the next layer
        x = L.rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits[:, 0], cache


def decode_step(
    params: Params,
    token: Any,                 # (B,) newest token ids
    cache: KVCache,
    cache_len: int,             # number of tokens already cached
    cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: logits (B, V) for the next position + the cache.

    This token's K/V are written into ``cache`` in place, at slot
    ``cache_len % capacity`` of every layer, and ``cache`` itself is
    returned: the reference returns an updated copy instead, which for a
    full-size cache would be a second cache-sized buffer per step."""
    with on_mesh(params):
        token = token_ids(token, params, policy)
        x = L.embed_tokens(params["embed"], token[:, None], cfg, policy)  # (B,1,D)
        q_pos = torch.full((1,), int(cache_len), dtype=torch.int32, device=x.device)
        for i in range(num_stacked(params["layers"])):
            x, _, _ = _layer_apply(
                layer_params(params["layers"], i), x, cfg, q_pos,
                kv=(cache.k[i], cache.v[i]), cache_len=int(cache_len), policy=policy,
            )
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits[:, 0], cache
