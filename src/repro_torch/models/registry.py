"""Uniform model API across families, the PyTorch port of
``repro.models.registry``.

``get_model(cfg)`` returns a :class:`ModelApi` whose members have identical
signatures regardless of family, so the server never branches on
architecture:

  init(generator, device=None)                   -> params
  param_specs(policy)                            -> spec tree of params
  forward(params, batch, policy=TP)              -> (logits, aux_loss)
  prefill(params, batch, policy=TP)              -> (last_logits, cache)
  decode_step(params, token, cache, n, policy=TP) -> (logits, cache)
  cache_shape(batch, seq_len)                    -> cache of meta tensors
  cache_spec(policy)                             -> cache of specs
  make_batch(tokens, features=None)              -> batch

``make_batch`` builds what ``forward`` and ``prefill`` take: for ``encdec``
a dict with ``features`` and ``tokens``; every other family takes the
token ids and ignores ``features``.  The policy is the reference's, as a
trailing argument defaulting to ``TP_POLICY``: it matters only on a mesh,
where the parameters are ``DTensor``s placed by
``fit_specs(params, param_specs(policy), mesh)``.

Unlike the reference, which returns an updated copy, ``decode_step``
updates ``cache`` in place (the token's K/V at slot ``n % capacity`` of
every attention layer, every Mamba2 layer's conv window and SSD state;
on a mesh on each rank's shards, the cache keeping its layout) and
returns that same object.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import cache as C
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.policy import TP_POLICY


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable
    param_specs: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    cache_shape: Callable
    cache_spec: Callable
    make_batch: Callable = lambda tokens, features=None: tokens


def _api(cfg: ModelConfig, module, cache_shape: Callable, cache_spec: Callable) -> ModelApi:
    """The API of a family whose ``forward`` and ``prefill`` take the batch
    as it comes (token ids)."""
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: module.init(generator, cfg, device),
        param_specs=lambda policy: module.param_specs(cfg, policy),
        forward=lambda p, tokens, policy=TP_POLICY: module.forward(p, tokens, cfg, policy=policy),
        prefill=lambda p, tokens, policy=TP_POLICY: module.prefill(p, tokens, cfg, policy=policy),
        decode_step=lambda p, tok, cache, n, policy=TP_POLICY: module.decode_step(
            p, tok, cache, n, cfg, policy=policy
        ),
        cache_shape=cache_shape,
        cache_spec=cache_spec,
    )


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    return _api(cfg, transformer,
                lambda batch, seq_len: C.kv_cache_shape(cfg, batch, seq_len),
                lambda policy: C.kv_cache_spec(cfg, policy))


def _ssm_api(cfg: ModelConfig) -> ModelApi:
    return _api(cfg, ssm,
                lambda batch, seq_len: C.ssm_cache_shape(cfg, batch),
                lambda policy: C.ssm_cache_spec(cfg, policy))


def _hybrid_api(cfg: ModelConfig) -> ModelApi:
    return _api(cfg, hybrid,
                lambda batch, seq_len: C.hybrid_cache_shape(cfg, batch, seq_len),
                lambda policy: C.hybrid_cache_spec(cfg, policy))


# Whisper's encoder output length used by decode-shape caches: 30 s of audio
# at 50 frames/s (the model card's 1500-frame receptive field).
WHISPER_ENC_LEN = 1500


def _encdec_api(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: encdec.init(generator, cfg, device),
        param_specs=lambda policy: encdec.param_specs(cfg, policy),
        forward=lambda p, batch, policy=TP_POLICY: encdec.forward(
            p, batch["features"], batch["tokens"], cfg, policy=policy),
        prefill=lambda p, batch, policy=TP_POLICY: encdec.prefill(
            p, batch["features"], batch["tokens"], cfg, policy=policy),
        decode_step=lambda p, tok, cache, n, policy=TP_POLICY: encdec.decode_step(
            p, tok, cache, n, cfg, policy=policy),
        cache_shape=lambda batch, seq_len: C.encdec_cache_shape(
            cfg, batch, seq_len, WHISPER_ENC_LEN
        ),
        cache_spec=lambda policy: C.encdec_cache_spec(cfg, policy),
        make_batch=lambda tokens, features=None: {"features": features, "tokens": tokens},
    )


_FAMILIES = {
    "dense": _transformer_api, "moe": _transformer_api, "vlm": _transformer_api,
    "ssm": _ssm_api, "hybrid": _hybrid_api, "encdec": _encdec_api,
}


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg)
