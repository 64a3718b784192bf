"""Decode-time KV caches, the PyTorch port of the attention part of
``repro.models.cache``.

A sliding-window config keeps a ring buffer of ``window`` slots, which is
what makes long-context decode feasible for SWA architectures (the cache is
O(window), not O(seq)).  Where the reference describes a cache abstractly
with ``ShapeDtypeStruct``s, the port uses tensors on the ``meta`` device.
The SSM, hybrid and enc-dec caches come with their families; the sharding
spec with the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


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
    return KVCache(
        k=torch.empty(shape, dtype=dt, device="meta"),
        v=torch.empty(shape, dtype=dt, device="meta"),
    )


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
