"""Mixture-of-experts MLP layer (Mixtral-style top-k + Qwen2-MoE shared
experts), the PyTorch port of ``repro.models.moe``.

Dispatch is the reference's **group-local gather**: tokens are split into
groups (one group per batch row when the sequence is long, one group over
the whole batch below 64 tokens); within each group the router's top-k
choices are sorted by expert (a stable sort) and gathered into a
capacity-padded ``(E, C, D)`` buffer; the expert FFNs run as one batched
einsum over the stacked expert weights.  Entries past an expert's capacity
drop, exactly the ones the reference drops.

The combine differs in mechanism, not in result: the reference scatter-adds
each slot back to its token, which on CUDA would be an atomic
``index_add_`` whose summation order is free.  Here each token gathers its
own kept slots and adds them in ascending expert order, the order of the
reference's scatter, so two calls give the same bits.

The expert-parallel sharding spec (``spec_moe_mlp``) comes with the next
slice (ROADMAP item 9b).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, dense_init

Params = Dict[str, Any]


def _trunc_normal(
    generator: torch.Generator, shape, std: float, dtype: torch.dtype,
    device: torch.device,
) -> torch.Tensor:
    """``std`` times a normal truncated at 2, drawn in fp32 on the
    generator's device, then moved and cast."""
    t = torch.empty(shape, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(device=device, dtype=dtype)


def init_moe_mlp(generator: torch.Generator, cfg: ModelConfig, device: torch.device) -> Params:
    """The reference's tree: router fp32 (D, E); ``w_gu`` (E, D, 2, F) with
    gate and up on the stack axis; ``w_down`` (E, F, D); with shared experts
    ``shared.w_gu`` (D, 2, Fs) and ``shared.w_down`` (Fs, D)."""
    dtype = cfg.params_dtype()
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    std = 1.0 / math.sqrt(d)
    router = dense_init(generator, d, (e,), torch.float32, device)
    w_gu = torch.empty((e, d, 2, f), dtype=dtype, device=device)
    for i in range(2):  # gate, then up: each drawn straight into its slot
        w_gu[:, :, i] = _trunc_normal(generator, (e, d, f), std, dtype, device)
    params: Params = {
        "router": router,
        "w_gu": w_gu,
        "w_down": _trunc_normal(generator, (e, f, d), 1.0 / math.sqrt(f), dtype, device),
    }
    if cfg.moe_num_shared_experts > 0:
        fs = cfg.moe_d_ff * cfg.moe_num_shared_experts
        gate = dense_init(generator, d, (fs,), dtype, device)
        up = dense_init(generator, d, (fs,), dtype, device)
        params["shared"] = {
            "w_gu": torch.stack([gate, up], dim=1),  # (D, 2, Fs)
            "w_down": dense_init(generator, fs, (d,), dtype, device),
        }
    return params


def route_logits(
    logits: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tail of :func:`_route` from fp32 router logits (G, S, E): expert
    ids (G, S, k), gates renormalised over the chosen k, and the full
    router probabilities (G, S, E) for the aux loss.  Padding experts
    (``moe_real_experts`` < E) get logit -1e30 and are never chosen."""
    real = cfg.moe_real_experts or cfg.moe_num_experts
    if real < cfg.moe_num_experts:
        pad = torch.arange(cfg.moe_num_experts, device=logits.device) >= real
        logits = logits.masked_fill(pad, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(logits, cfg.moe_top_k, dim=-1)
    gates = torch.softmax(gate_vals, dim=-1)
    return expert_ids, gates, probs


def _route(
    router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  x: (G, S, D) -> expert ids (G, S, k), gates (G, S, k),
    router probs (G, S, E); the logits are taken in fp32."""
    return route_logits(x.float() @ router.float(), cfg)


def load_balance_loss(
    probs: torch.Tensor, expert_ids: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e."""
    e = cfg.moe_num_experts
    onehot = F.one_hot(expert_ids, e).float()  # (G, S, k, E)
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    return e * torch.sum(frac_tokens * mean_prob)


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    """Slots per expert and group: ``max(ceil(S k / E * cf), k)``."""
    k, e = cfg.moe_top_k, cfg.moe_num_experts
    return max(int(math.ceil(tokens_per_group * k / e * cfg.moe_capacity_factor)), k)


def dispatch(
    expert_ids: torch.Tensor, num_experts: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch table from expert ids (G, S, k).

    Returns ``table`` (G, E, C): the token index held by each slot, ``S``
    in an empty slot; and ``slot`` (G, S, k): each choice's flat slot
    ``expert * C + rank``, or ``E * C`` where the choice dropped.  A
    choice's rank is its position within its expert's entries after a
    stable sort by expert, so the earlier tokens keep their slots; ranks
    from ``C`` on drop."""
    g, sg, k = expert_ids.shape
    dev = expert_ids.device
    flat_e = expert_ids.reshape(g, sg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(
        se.contiguous(), torch.arange(num_experts, device=dev).expand(g, -1).contiguous()
    )
    rank = torch.arange(sg * k, device=dev) - torch.gather(first, 1, se)
    keep = rank < cap
    # Sorted entry -> flat slot; a dropped entry goes to the spare slot E*C.
    sorted_slot = torch.where(keep, se * cap + rank, num_experts * cap)
    slot = torch.empty_like(sorted_slot).scatter_(1, order, sorted_slot)
    tokens = torch.div(order, k, rounding_mode="floor")
    table = torch.full((g, num_experts * cap + 1), sg, dtype=torch.long, device=dev)
    table.scatter_(1, sorted_slot, tokens)  # only the spare slot sees duplicates
    return table[:, :-1].reshape(g, num_experts, cap), slot.reshape(g, sg, k)


def moe_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: (B, S, D).  Returns (y, aux_loss).

    Grouping, as in the reference: one group per batch row when S >= 64,
    else one group over the whole batch (a decode step's routing pools the
    batch, padding rows included)."""
    b, s, d = x.shape
    xg = x if s >= 64 else x.reshape(1, b * s, d)
    g, sg, _ = xg.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = capacity(sg, cfg)

    expert_ids, gates, probs = _route(params["router"], xg, cfg)
    aux = load_balance_loss(probs, expert_ids, cfg)
    table, slot = dispatch(expert_ids, e, cap)

    # Gather each slot's token; the empty slot's index ``sg`` reads a zero row.
    xpad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = xpad[torch.arange(g, device=x.device)[:, None, None], table]  # (G, E, C, D)

    hgu = torch.einsum("gecd,edkf->geckf", xe, params["w_gu"])
    hg, hu = hgu[..., 0, :], hgu[..., 1, :]
    h = F.silu(hg.float()).to(hu.dtype) * hu
    ye = torch.einsum("gecf,efd->gecd", h, params["w_down"])  # (G, E, C, D)

    # Combine: each token's kept slots, gate-weighted, added in ascending
    # expert order; the spare slot E*C is a zero row (a dropped choice).
    yflat = torch.cat([ye.reshape(g, e * cap, d), ye.new_zeros(g, 1, d)], dim=1)
    by_expert = torch.argsort(expert_ids, dim=-1)
    slot = torch.gather(slot, 2, by_expert)
    gate = torch.gather(gates, 2, by_expert).to(ye.dtype)
    gi = torch.arange(g, device=x.device)[:, None]
    out = torch.zeros((g, sg, d), dtype=ye.dtype, device=x.device)
    for j in range(k):
        out = out + yflat[gi, slot[:, :, j]] * gate[:, :, j, None]

    if "shared" in params:
        sh = params["shared"]
        hgu_s = torch.einsum("gsd,dkf->gskf", xg, sh["w_gu"])
        hs = F.silu(hgu_s[:, :, 0].float()).to(xg.dtype) * hgu_s[:, :, 1]
        out = out + hs @ sh["w_down"]
    return out.reshape(b, s, d), aux
