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
from repro_torch.sharding.utils import is_dtensor, local_extent, on_mesh, place_like
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

    On a mesh the logits keep their layout, batch rows and vocabulary
    split (:func:`_cross_entropy_on_mesh`)."""
    b, s, _v = logits.shape
    if s % chunk != 0:
        chunk = s  # fall back to a single chunk for ragged tiny inputs
    labels = torch.as_tensor(labels, device=logits.device).long()
    if is_dtensor(logits):
        return _cross_entropy_on_mesh(logits, labels, mask, chunk)
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


def _cross_entropy_on_mesh(logits: Any, labels: torch.Tensor, mask: Optional[torch.Tensor],
                           chunk: int) -> torch.Tensor:
    """:func:`cross_entropy_chunked` of ``DTensor`` logits, vocabulary-parallel.

    The logits stay in their layout (the reference's: batch rows over the
    batch axes, the vocabulary over ``model``).  Each rank takes, through
    ``local_map`` and chunk by chunk, the max of its own vocabulary slice
    (gathered, so every rank shifts by the row's max), the sum of
    exponentials over its slice, and the target logit where its slice holds
    the label (zero elsewhere): the last two are partial sums over the
    vocabulary shards, reduced before the log.  No rank holds more than
    its own rows of its own vocabulary slice, in fp32 one chunk at a time.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    b, s, v = logits.shape
    pls = [pl if pl in (Shard(0), Shard(2)) else Replicate() for pl in logits.placements]
    rows = [pl if pl == Shard(0) else Replicate() for pl in pls]
    # The per-row statistics: partial sums over the vocabulary shards; the
    # per-shard maxima: one column per vocabulary shard.
    sums = [Partial() if pl == Shard(2) else pl for pl in pls]
    maxes = [pl if pl == Shard(0) else (Shard(2) if pl == Shard(2) else Replicate())
             for pl in pls]
    off, n = local_extent((b, s, v), pls, mesh)[2]

    def local_max(lg: torch.Tensor) -> torch.Tensor:
        return torch.cat([lg[:, c0:c0 + chunk].float().amax(-1) for c0 in range(0, s, chunk)],
                         dim=1)[..., None]

    def local_stats(lg: torch.Tensor, lab: torch.Tensor, mx: torch.Tensor):
        sumexp, tgt = [], []
        for c0 in range(0, s, chunk):
            lg32 = lg[:, c0:c0 + chunk].float()
            sumexp.append(torch.exp(lg32 - mx[:, c0:c0 + chunk, None]).sum(-1))
            loc = lab[:, c0:c0 + chunk] - off
            hit = (loc >= 0) & (loc < n)
            t = torch.gather(lg32, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
            tgt.append(torch.where(hit, t, torch.zeros((), dtype=t.dtype, device=t.device)))
        return torch.cat(sumexp, dim=1), torch.cat(tgt, dim=1)

    with torch.no_grad():
        mx = local_map(local_max, out_placements=maxes, in_placements=(pls,),
                       device_mesh=mesh, redistribute_inputs=True)(logits.detach())
        mx = mx.redistribute(mesh, rows).amax(-1)
    labels = place_like(labels, mx)
    sumexp, tgt = local_map(
        local_stats, out_placements=(sums, sums), in_placements=(pls, rows, rows),
        in_grad_placements=(pls, rows, rows), device_mesh=mesh, redistribute_inputs=True,
    )(logits, labels, mx)
    nll = (torch.log(sumexp.redistribute(mesh, rows)) + mx) - tgt.redistribute(mesh, rows)
    mk = (torch.ones((b, s), dtype=torch.float32, device=logits.device)
          if mask is None else mask.float())
    mk = place_like(mk, mx)
    return (nll * mk).sum() / torch.clamp(mk.sum(), min=1.0)


def lm_loss(model: ModelApi, params: Params, batch: Any,
            policy: ShardingPolicy = TP_POLICY) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token LM loss (teacher-forced).  ``batch``: tokens (B, S) or the
    enc-dec dict of ``features`` and ``tokens``; the loss predicts
    tokens[1:] from tokens[:-1], plus the MoE's weighted aux loss.  The
    logits are not sliced: the labels shift by one and the last position is
    masked, which gives the same mean over B (S - 1) positions."""
    cfg = model.cfg
    tokens = batch["tokens"] if cfg.family == "encdec" else batch
    logits, aux = model.forward(params, batch, policy)
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    b, s = tokens.shape
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.ones((b, s), dtype=torch.float32, device=logits.device)
    mask[:, -1] = 0.0
    ce = cross_entropy_chunked(logits, labels, mask, chunk=cfg.loss_chunk)
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
