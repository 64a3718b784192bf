"""Training step and loss for the architecture zoo, the PyTorch port of
``repro.training.train_loop``.

The cross-entropy is computed in sequence chunks (``cfg.loss_chunk``) with
the softmax statistics in fp32, so the fp32 logits of one chunk, never of
the whole (B, S, V), are made at a time in the forward.  Gradients come
from ``torch.autograd.grad`` over the params tree's leaves; on CUDA the
attention's come from the flash kernel's backward
(:class:`repro_torch.kernels.flash_attention.FlashAttentionFunction`).

The reference's sharding ``policy`` is the trailing argument of
:func:`lm_loss`, :func:`loss_and_grads` and :func:`make_train_step`
(``TP_POLICY`` by default).  With the params placed on a mesh (``DTensor``
leaves, ``fit_specs(params, model.param_specs(policy), mesh)``) the loss
and its backward run on the mesh under ``implicit_replication``, each
rank's attention and SSD backward kernels on its local shards, and every
gradient comes back in its parameter's placements (partial sums reduced),
so the optimizer's moments and updates keep the layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, tree_leaves, tree_map
from repro_torch.models.registry import ModelApi
from repro_torch.sharding.policy import TP_POLICY, ShardingPolicy
from repro_torch.sharding.utils import is_dtensor, on_mesh, place_like
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, zeros_f32,
)

Params = Any


def cross_entropy_chunked(
    logits: torch.Tensor,                 # (B, S, V) any float dtype
    labels: Any,                          # (B, S) int
    mask: Optional[torch.Tensor] = None,  # (B, S) 1/0
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token NLL, computed chunk by chunk along the sequence.

    On a mesh the logits are first laid out by rows: the batch keeps its
    shards, the vocabulary is gathered whole (DTensor has no sound rule
    for a gather along a sharded vocabulary), and the labels are placed
    alike."""
    b, s, _v = logits.shape
    if s % chunk != 0:
        chunk = s  # fall back to a single chunk for ragged tiny inputs
    labels = torch.as_tensor(labels, device=logits.device).long()
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate, Shard

        rows = [pl if pl == Shard(0) else Replicate() for pl in logits.placements]
        logits = logits.redistribute(logits.device_mesh, rows)
        labels = place_like(labels, logits)
    tot = torch.zeros((), dtype=torch.float32, device=logits.device)
    cnt = torch.zeros((), dtype=torch.float32, device=logits.device)
    for c0 in range(0, s, chunk):
        lg32 = logits[:, c0:c0 + chunk].float()
        m = torch.logsumexp(lg32, dim=-1)
        tgt = torch.gather(lg32, -1, labels[:, c0:c0 + chunk, None])[..., 0]
        mk = (torch.ones((b, chunk), dtype=torch.float32, device=logits.device)
              if mask is None else mask[:, c0:c0 + chunk].float())
        tot = tot + ((m - tgt) * mk).sum()
        cnt = cnt + mk.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(model: ModelApi, params: Params, batch: Any,
            policy: ShardingPolicy = TP_POLICY) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token LM loss (teacher-forced).  ``batch``: tokens (B, S) or the
    enc-dec dict of ``features`` and ``tokens``; the loss predicts
    tokens[1:] from tokens[:-1], plus the MoE's weighted aux loss."""
    cfg = model.cfg
    tokens = batch["tokens"] if cfg.family == "encdec" else batch
    logits, aux = model.forward(params, batch, policy)
    tokens = torch.as_tensor(tokens, device=logits.device)
    ce = cross_entropy_chunked(logits[:, :-1], tokens[:, 1:], chunk=cfg.loss_chunk)
    loss = ce + cfg.moe_aux_loss_weight * aux
    return loss, {"ce": ce, "aux": aux}


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: AdamWState


def _grads_of(model: ModelApi, params: Params, batch: Any, policy: ShardingPolicy):
    """(loss, parts, grads) of one batch: the params' leaves as fresh leaves
    that require grad, and ``torch.autograd.grad`` over all of them (which
    raises if a leaf is cut off from the loss).  On a mesh the loss comes
    back whole on every rank and each gradient in its parameter's
    placements."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    with on_mesh(params):
        loss, parts = lm_loss(model, tree_map(lambda _p: next(it), params), batch, policy)
        grads = [_like(g, p) for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
    grads_it = iter(grads)
    return (_whole(loss.detach()), {k: _whole(v.detach()) for k, v in parts.items()},
            tree_map(lambda _p: next(grads_it), params))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A scalar ``DTensor`` as the plain tensor every rank holds."""
    return t.full_tensor() if is_dtensor(t) else t


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements (a partial sum reduced)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split(batch: Any, n: int) -> list:
    """``n`` microbatches along the leading axis of every array of ``batch``."""
    def rows(x: Any, i: int) -> Any:
        b = x.shape[0]
        if b % n != 0:
            raise ValueError(f"batch {b} not divisible by grad_accum {n}")
        return x[i * (b // n):(i + 1) * (b // n)]

    if isinstance(batch, dict):
        return [{k: rows(v, i) for k, v in batch.items()} for i in range(n)]
    return [rows(batch, i) for i in range(n)]


def loss_and_grads(
    model: ModelApi, params: Params, batch: Any, grad_accum: int = 1,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Params]:
    """(loss, {"ce", "aux"}, grads) of ``batch``.  With ``grad_accum > 1``
    the batch's leading axis is split into that many microbatches, whose
    fp32 gradients, losses and aux losses are each summed divided by
    ``grad_accum``, in order, as the reference's scan does."""
    if grad_accum == 1:
        return _grads_of(model, params, batch, policy)
    acc = tree_map(zeros_f32, params)
    loss = aux = None
    for mb in _split(batch, grad_accum):
        mb_loss, parts, grads = _grads_of(model, params, mb, policy)
        for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
            a.add_(g.float() / grad_accum)
        del grads
        loss = mb_loss / grad_accum if loss is None else loss + mb_loss / grad_accum
        aux = parts["aux"] / grad_accum if aux is None else aux + parts["aux"] / grad_accum
    return loss, {"ce": loss, "aux": aux}, acc


def make_train_step(
    model: ModelApi, opt_cfg: AdamWConfig, policy: ShardingPolicy = TP_POLICY,
    grad_accum: int = 1,
) -> Callable:
    """The train step: grads -> clip -> AdamW -> metrics.

    ``train_step(params, opt, batch)`` returns (new_params, new_opt,
    metrics) with metrics ``loss``, ``ce``, ``aux``, ``lr`` and
    ``grad_norm``.  ``opt``'s moments are updated in place
    (:func:`~repro_torch.training.optimizer.adamw_update`).  With
    ``grad_accum > 1`` the batch is split into microbatches
    (:func:`loss_and_grads`): live activations scale with the microbatch.
    """

    def train_step(params: Params, opt: AdamWState, batch: Any):
        loss, parts, grads = loss_and_grads(model, params, batch, grad_accum, policy)
        new_params, new_opt, om = adamw_update(opt_cfg, grads, opt, params)
        return new_params, new_opt, {"loss": loss, **parts, **om}

    return train_step


def init_train_state(
    model: ModelApi, generator: torch.Generator, device: DeviceLike = None,
) -> TrainState:
    params = model.init(generator, device)
    return TrainState(params=params, opt=adamw_init(params))
