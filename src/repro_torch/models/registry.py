"""Uniform model API across families, the PyTorch port of
``repro.models.registry``.

``get_model(cfg)`` returns a :class:`ModelApi` whose members have identical
signatures regardless of family, so the server never branches on
architecture:

  init(generator, device=None)           -> params
  forward(params, batch)                 -> (logits, aux_loss)
  prefill(params, batch)                 -> (last_logits, cache)
  decode_step(params, token, cache, n)   -> (logits, cache)
  cache_shape(batch, seq_len)            -> cache of meta tensors
  make_batch(tokens, features=None)      -> batch

``make_batch`` builds what ``forward`` and ``prefill`` take: for ``encdec``
a dict with ``features`` and ``tokens``; every other family takes the
token ids and ignores ``features``.

Unlike the reference, which returns an updated copy, ``decode_step``
updates ``cache`` in place (the token's K/V at slot ``n % capacity`` of
every attention layer, every Mamba2 layer's conv window and SSD state) and
returns that same object.

The reference's sharding members (``param_specs``, ``cache_spec``) come
with the next slice (ROADMAP item 9b).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import cache as C
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    cache_shape: Callable
    make_batch: Callable = lambda tokens, features=None: tokens


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: transformer.init(generator, cfg, device),
        forward=lambda p, tokens: transformer.forward(p, tokens, cfg),
        prefill=lambda p, tokens: transformer.prefill(p, tokens, cfg),
        decode_step=lambda p, tok, cache, n: transformer.decode_step(
            p, tok, cache, n, cfg
        ),
        cache_shape=lambda batch, seq_len: C.kv_cache_shape(cfg, batch, seq_len),
    )


def _ssm_api(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: ssm.init(generator, cfg, device),
        forward=lambda p, tokens: ssm.forward(p, tokens, cfg),
        prefill=lambda p, tokens: ssm.prefill(p, tokens, cfg),
        decode_step=lambda p, tok, cache, n: ssm.decode_step(p, tok, cache, n, cfg),
        cache_shape=lambda batch, seq_len: C.ssm_cache_shape(cfg, batch),
    )


def _hybrid_api(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: hybrid.init(generator, cfg, device),
        forward=lambda p, tokens: hybrid.forward(p, tokens, cfg),
        prefill=lambda p, tokens: hybrid.prefill(p, tokens, cfg),
        decode_step=lambda p, tok, cache, n: hybrid.decode_step(p, tok, cache, n, cfg),
        cache_shape=lambda batch, seq_len: C.hybrid_cache_shape(cfg, batch, seq_len),
    )


# Whisper's encoder output length used by decode-shape caches: 30 s of audio
# at 50 frames/s (the model card's 1500-frame receptive field).
WHISPER_ENC_LEN = 1500


def _encdec_api(cfg: ModelConfig) -> ModelApi:
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device=None: encdec.init(generator, cfg, device),
        forward=lambda p, batch: encdec.forward(p, batch["features"], batch["tokens"], cfg),
        prefill=lambda p, batch: encdec.prefill(p, batch["features"], batch["tokens"], cfg),
        decode_step=lambda p, tok, cache, n: encdec.decode_step(p, tok, cache, n, cfg),
        cache_shape=lambda batch, seq_len: C.encdec_cache_shape(
            cfg, batch, seq_len, WHISPER_ENC_LEN
        ),
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
