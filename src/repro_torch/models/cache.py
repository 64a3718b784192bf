"""Decode-time caches, the PyTorch port of ``repro.models.cache``: the KV
cache of the attention families, the SSM cache of Mamba2, the hybrid
cache of Zamba2 and the enc-dec cache of Whisper.

A sliding-window config keeps a ring buffer of ``window`` slots, which is
what makes long-context decode feasible for SWA architectures (the cache is
O(window), not O(seq)).  Where the reference describes a cache abstractly
with ``ShapeDtypeStruct``s, the port uses tensors on the ``meta`` device.

Each cache has the reference's spec function (``kv_cache_spec``,
``ssm_cache_spec``, ``hybrid_cache_spec``, ``encdec_cache_spec``): a cache
of the same dataclass holding a :class:`~repro_torch.sharding.policy.P` per
tensor.  :func:`place_cache` lays a cache out on a mesh by such a spec and
:func:`zeros_like_spec` allocates a zero cache directly in that layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import P, ShardingPolicy, _ambient_mesh, mesh_axes


def shape_of(shape: Any, dtype: torch.dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` that holds no storage (one
    element broadcast): a description of a tensor, as the reference's
    ``ShapeDtypeStruct``, which a dry run inside the step that makes it
    does not count as memory."""
    return torch.empty((), dtype=dtype, device="meta").expand(shape)


@dataclasses.dataclass
class KVCache:
    """Stacked per-layer KV cache: ``k``/``v`` are (L, B, T, Hk, Dh)."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[2]


def kv_cache_shape(
    cfg: ModelConfig, batch: int, seq_len: int, layers: Optional[int] = None
) -> KVCache:
    """Meta tensors of a cache able to attend over ``seq_len`` tokens.

    For sliding-window configs the allocation is ``min(seq_len, window)``
    slots (ring buffer) — the long-context enabler.
    """
    t = seq_len if cfg.sliding_window is None else min(seq_len, cfg.sliding_window)
    layers = layers if layers is not None else cfg.num_layers
    shape = (layers, batch, t, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype()
    return KVCache(k=shape_of(shape, dt), v=shape_of(shape, dt))


def kv_cache_zeros(
    cfg: ModelConfig, batch: int, seq_len: int, layers: Optional[int] = None,
    *, device: DeviceLike = None,
) -> KVCache:
    """A zero cache on ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    s = kv_cache_shape(cfg, batch, seq_len, layers)
    return KVCache(
        k=torch.zeros(s.k.shape, dtype=s.k.dtype, device=device),
        v=torch.zeros(s.v.shape, dtype=s.v.dtype, device=device),
    )


def kv_cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> KVCache:
    """Batch over data axes; heads or sequence over the model axis.

    Mesh-adaptive, as the reference: where the KV-head count divides the
    ambient mesh's model axis the heads shard; where it does not (MQA,
    GQA with few KV heads) the cache would be fully replicated, so the
    sequence axis shards instead.
    """
    b = policy.physical("batch")
    m = policy.physical("model")
    mesh = _ambient_mesh()
    model_size = 1
    if mesh is not None and isinstance(m, str) and m in mesh_axes(mesh):
        model_size = mesh_axes(mesh)[m]
    if model_size > 1 and cfg.n_kv_heads % model_size != 0:
        spec = P(None, b, m, None, None)   # sequence-sharded ring/cache
    else:
        spec = P(None, b, None, m, None)   # head-sharded
    return KVCache(k=spec, v=spec)


@dataclasses.dataclass
class SSMCache:
    """Mamba2 decode state: conv ring + SSD state, stacked over layers.

    ``conv``: (L, B, W-1, conv_dim) last inputs for the causal conv.
    ``state``: (L, B, H, P, N) SSD recurrent state (fp32).
    """

    conv: torch.Tensor
    state: torch.Tensor


def ssm_cache_shape(cfg: ModelConfig, batch: int, layers: Optional[int] = None) -> SSMCache:
    layers = layers if layers is not None else cfg.num_layers
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return SSMCache(
        conv=shape_of((layers, batch, cfg.ssm_conv_width - 1, conv_dim), cfg.activation_dtype()),
        state=shape_of((layers, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                       torch.float32),
    )


def ssm_cache_zeros(
    cfg: ModelConfig, batch: int, layers: Optional[int] = None, *, device: DeviceLike = None,
) -> SSMCache:
    """A zero SSM cache on ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    s = ssm_cache_shape(cfg, batch, layers)
    return SSMCache(conv=torch.zeros_like(s.conv, device=device),
                    state=torch.zeros_like(s.state, device=device))


def ssm_cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> SSMCache:
    b = policy.physical("batch")
    m = policy.physical("model")
    return SSMCache(conv=P(None, b, None, None), state=P(None, b, m, None, None))


@dataclasses.dataclass
class HybridCache:
    """Zamba2 decode state: SSM caches for every Mamba2 layer + KV caches for
    each invocation of the globally-shared attention block."""

    ssm: SSMCache
    kv: KVCache


def hybrid_cache_shape(cfg: ModelConfig, batch: int, seq_len: int) -> HybridCache:
    n_inv = cfg.num_layers // cfg.hybrid_attn_period
    return HybridCache(
        ssm=ssm_cache_shape(cfg, batch, layers=cfg.num_layers),
        kv=kv_cache_shape(cfg, batch, seq_len, layers=n_inv),
    )


def hybrid_cache_zeros(
    cfg: ModelConfig, batch: int, seq_len: int, *, device: DeviceLike = None,
) -> HybridCache:
    """A zero hybrid cache on ``device`` (``cuda`` unless the caller names another)."""
    n_inv = cfg.num_layers // cfg.hybrid_attn_period
    return HybridCache(
        ssm=ssm_cache_zeros(cfg, batch, layers=cfg.num_layers, device=device),
        kv=kv_cache_zeros(cfg, batch, seq_len, layers=n_inv, device=device),
    )


def hybrid_cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> HybridCache:
    return HybridCache(ssm=ssm_cache_spec(cfg, policy), kv=kv_cache_spec(cfg, policy))


@dataclasses.dataclass
class EncDecCache:
    """Whisper decode state: decoder self-attention KV + encoder cross K/V
    (computed once from the encoder output at prefill)."""

    self_kv: KVCache
    cross_k: torch.Tensor  # (L, B, T_enc, Hk, Dh)
    cross_v: torch.Tensor


def encdec_cache_shape(cfg: ModelConfig, batch: int, dec_len: int, enc_len: int,
                       layers: Optional[int] = None) -> EncDecCache:
    layers = layers if layers is not None else cfg.num_layers
    cross = (layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype()
    return EncDecCache(
        self_kv=kv_cache_shape(cfg, batch, dec_len, layers),
        cross_k=shape_of(cross, dt),
        cross_v=shape_of(cross, dt),
    )


def encdec_cache_zeros(
    cfg: ModelConfig, batch: int, dec_len: int, enc_len: int, *, device: DeviceLike = None,
) -> EncDecCache:
    """A zero enc-dec cache on ``device`` (``cuda`` unless the caller names another)."""
    device = resolve_device(device)
    s = encdec_cache_shape(cfg, batch, dec_len, enc_len)
    return EncDecCache(
        self_kv=kv_cache_zeros(cfg, batch, dec_len, device=device),
        cross_k=torch.zeros_like(s.cross_k, device=device),
        cross_v=torch.zeros_like(s.cross_v, device=device),
    )


def encdec_cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> EncDecCache:
    b = policy.physical("batch")
    m = policy.physical("model")
    cross = P(None, b, None, m, None)
    return EncDecCache(self_kv=kv_cache_spec(cfg, policy), cross_k=cross, cross_v=cross)


def map_cache(fn, cache: Any, *others: Any) -> Any:
    """``fn(tensor, *matching leaves of others)`` over the tensors of a cache
    dataclass (nested caches included), into a cache of the same type."""
    if dataclasses.is_dataclass(cache):
        return type(cache)(**{
            f.name: map_cache(fn, getattr(cache, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(cache)})
    return fn(cache, *others)


def cache_leaves(cache: Any) -> list:
    """The tensors of a cache dataclass, nested caches included."""
    leaves: list = []
    map_cache(leaves.append, cache)
    return leaves


def place_cache(cache: Any, spec: Any, mesh: Any) -> Any:
    """``cache`` laid out on ``mesh`` by ``spec`` (a cache of :class:`P`,
    fitted to each tensor's shape): a plain tensor is placed from its full
    value (no collective), a ``DTensor`` redistributed."""
    from repro_torch.sharding.utils import fit_spec, is_dtensor, place, placements

    def one(t, sp):
        sp = fit_spec(tuple(t.shape), sp, mesh)
        if is_dtensor(t):
            return t.redistribute(mesh, placements(sp, mesh))
        return place(t, sp, mesh)

    return map_cache(one, cache, spec)


def zeros_like_spec(shapes: Any, spec: Any, mesh: Any, device: torch.device) -> Any:
    """A zero cache of ``shapes``' shapes and dtypes (a cache of tensors,
    ``meta`` ones included) on ``device`` (``meta`` in a dry run), each
    tensor allocated as its own shard of ``spec``'s fitted layout on
    ``mesh``: no rank ever holds a full copy."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.utils import _contiguous_strides, fit_spec, local_extent, placements

    def one(t, sp):
        pls = placements(fit_spec(tuple(t.shape), sp, mesh), mesh)
        local = [n for _, n in local_extent(t.shape, pls, mesh)]
        z = torch.zeros(local, dtype=t.dtype, device=device)
        return DTensor.from_local(z, mesh, pls, run_check=False, shape=t.shape,
                                  stride=_contiguous_strides(t.shape))

    return map_cache(one, shapes, spec)


def prefill_cache(shapes: Any, spec: Any, mesh: Any, device: torch.device) -> Any:
    """The cache a prefill fills layer by layer, allocated once at its full
    (L, ...) shapes (``shapes``, a cache of ``meta`` tensors) and zeroed: on
    ``mesh`` shard by shard in ``spec``'s fitted layout
    (:func:`zeros_like_spec`), off a mesh one plain tensor each on
    ``device``."""
    if mesh is not None:
        return zeros_like_spec(shapes, spec, mesh, device)
    return map_cache(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), shapes)
