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

With ``policy.expert`` set, :func:`spec_moe_mlp` shards the stacked expert
weights over the expert axis (each ``model`` rank holds E / n experts);
without it the experts are co-located and tensor-parallel inside.  On a
mesh the routing, the expert FFNs and the combine each run per rank
through ``local_map`` (:func:`_moe_on_mesh`): a long sequence's groups are
its batch rows, sharded like the batch, and a decode step's single group
spans the whole batch, so its rows are gathered and every rank routes them
alike — routing stays the reference's, drops included.  The experts run
where their weights lie, which is the layout of the reference's two
expert ``shard_act`` constraints, and the combine gathers their outputs
over ``model`` before each token adds its kept slots in expert order.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NEG_INF, dense_init
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import is_dtensor

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


def spec_moe_mlp(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    m, f = policy.physical("model"), policy.physical("fsdp")
    e = policy.physical("expert")
    if e is not None:
        # Expert parallelism: expert dim over the expert axis, FFN dims whole.
        expert_spec = {"w_gu": P(e, f, None, None), "w_down": P(e, None, f)}
    else:
        # Baseline: experts co-located, tensor-parallel inside each expert.
        expert_spec = {"w_gu": P(None, f, None, m), "w_down": P(None, m, f)}
    spec: Params = {"router": P(None, None), **expert_spec}
    if cfg.moe_num_shared_experts > 0:
        spec["shared"] = {"w_gu": P(f, None, m), "w_down": P(m, f)}
    return spec


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


def _combine(ye: torch.Tensor, expert_ids: torch.Tensor, gates: torch.Tensor,
             slot: torch.Tensor) -> torch.Tensor:
    """(G, S, D): each token's kept slots of ``ye`` (G, E, C, D),
    gate-weighted, added in ascending expert order; the spare slot E*C is a
    zero row (a dropped choice)."""
    g, e, cap, d = ye.shape
    sg, k = slot.shape[1], slot.shape[2]
    yflat = torch.cat([ye.reshape(g, e * cap, d), ye.new_zeros(g, 1, d)], dim=1)
    by_expert = torch.argsort(expert_ids, dim=-1)
    slot = torch.gather(slot, 2, by_expert)
    gate = torch.gather(gates, 2, by_expert).to(ye.dtype)
    gi = torch.arange(g, device=ye.device)[:, None]
    out = torch.zeros((g, sg, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        out = out + yflat[gi, slot[:, :, j]] * gate[:, :, j, None]
    return out


def _dispatch_local(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Routing, dispatch table and the (G, E, C, D) gather of whole groups
    on one rank: returns xe, expert ids, gates, slots and the per-group
    means of the router's choices and probabilities (G, E) that the aux
    loss averages."""
    g, sg, d = xg.shape
    cap = capacity(sg, cfg)
    expert_ids, gates, probs = _route(router, xg, cfg)
    table, slot = dispatch(expert_ids, cfg.moe_num_experts, cap)
    xpad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = xpad[torch.arange(g, device=xg.device)[:, None, None], table]
    chosen = F.one_hot(expert_ids, cfg.moe_num_experts).float().sum(dim=2).mean(dim=1)
    return xe, expert_ids, gates, slot, chosen, probs.mean(dim=1)


def _experts(xe: torch.Tensor, w_gu: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The expert FFNs of the dispatched slots xe (G, E, C, D): batched
    einsums over the stacked weights, (G, E, C, D) out."""
    hgu = torch.einsum("gecd,edkf->geckf", xe, w_gu)
    hg, hu = hgu[..., 0, :], hgu[..., 1, :]
    h = F.silu(hg.float()).to(hu.dtype) * hu
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _moe_on_mesh(params: Params, xg: Any, cfg: ModelConfig, policy: ShardingPolicy):
    """The MoE of ``DTensor`` groups xg (G, Sg, D): (out (G, Sg, D), aux).

    Three ``local_map``s.  The routing: whole groups per rank — each
    batch-sharding mesh dimension keeps the groups sharded where they
    divide (the rows of a long sequence) and every other dimension
    replicates them, so each rank routes, builds the table and gathers its
    own groups exactly as one device would; the router's gradient is a
    partial sum over the group shards.  The experts: per mesh dimension as
    the (fsdp-gathered) expert weights lie — over the experts (the
    reference's ``shard_act(xe, "batch", "expert", ...)``: each rank runs
    its E / n experts on their slots), over each expert's FFN width (the
    output a partial sum), or over the groups.  The combine: whole groups
    again, the experts' outputs gathered over ``model``.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xg.device_mesh
    batch = set(policy.batch)
    grouped, n = [], 1
    for mdim, name in enumerate(mesh.mesh_dim_names):
        size = mesh.size(mdim)
        if name in batch and size > 1 and xg.shape[0] % (n * size) == 0:
            n *= size
            grouped.append(Shard(0))
        else:
            grouped.append(Replicate())
    rep = [Replicate()] * mesh.ndim
    partial_over_groups = [Partial() if pl.is_shard() else Replicate() for pl in grouped]
    xe, expert_ids, gates, slot, chosen, mean_p = local_map(
        lambda a, r: _dispatch_local(a, r, cfg),
        out_placements=(grouped,) * 6, in_placements=(grouped, rep),
        in_grad_placements=(grouped, partial_over_groups),
        device_mesh=mesh, redistribute_inputs=True,
    )(xg, params["router"])
    aux = cfg.moe_num_experts * torch.sum(chosen.mean(dim=0) * mean_p.mean(dim=0))

    # Per mesh dim: (xe, w_gu, w_down, ye) placements and the grads' of
    # (xe, w_gu, w_down).
    rows = []
    for g, w in zip(grouped, params["w_gu"].placements):
        if w == Shard(0):    # experts split
            rows.append((Shard(1), Shard(0), Shard(0), Shard(1), Shard(1), Shard(0), Shard(0)))
        elif w == Shard(3):  # each expert's FFN width split
            rows.append((Replicate(), Shard(3), Shard(1), Partial(),
                         Partial(), Shard(3), Shard(1)))
        elif g.is_shard():   # groups split, weights whole
            rows.append((g, Replicate(), Replicate(), g, g, Partial(), Partial()))
        else:
            rows.append((Replicate(),) * 7)
    xl, gul, dl, yl, gxl, ggul, gdl = (list(c) for c in zip(*rows))
    ye = local_map(
        _experts, out_placements=yl, in_placements=(xl, gul, dl),
        in_grad_placements=(gxl, ggul, gdl), device_mesh=mesh, redistribute_inputs=True,
    )(xe, params["w_gu"], params["w_down"])
    out = local_map(
        _combine, out_placements=grouped,
        in_placements=(grouped, grouped, grouped, grouped),
        device_mesh=mesh, redistribute_inputs=True,
    )(ye, expert_ids, gates, slot)
    return out, aux


def moe_mlp(params: Params, x: torch.Tensor, cfg: ModelConfig,
            policy: ShardingPolicy = TP_POLICY) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE layer.  x: (B, S, D).  Returns (y, aux_loss).

    Grouping, as in the reference: one group per batch row when S >= 64,
    else one group over the whole batch (a decode step's routing pools the
    batch, padding rows included)."""
    b, s, d = x.shape
    xg = x if s >= 64 else x.reshape(1, b * s, d)
    route = _moe_on_mesh if is_dtensor(x) else _moe_groups
    out, aux = route(params, xg, cfg, policy)
    if "shared" in params:
        out = out + _shared_experts(params["shared"], xg)
    return shard_act(out.reshape(b, s, d), policy, "batch", None, None), aux


def _moe_groups(params: Params, xg: torch.Tensor, cfg: ModelConfig,
                policy: ShardingPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of the groups xg (G, Sg, D) on one device:
    (out (G, Sg, D), aux)."""
    g, sg, d = xg.shape
    cap = capacity(sg, cfg)
    expert_ids, gates, probs = _route(params["router"], xg, cfg)
    aux = load_balance_loss(probs, expert_ids, cfg)
    table, slot = dispatch(expert_ids, cfg.moe_num_experts, cap)

    # Gather each slot's token; the empty slot's index ``sg`` reads a zero row.
    xpad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = xpad[torch.arange(g, device=xg.device)[:, None, None], table]  # (G, E, C, D)
    ye = _experts(xe, params["w_gu"], params["w_down"])  # (G, E, C, D)
    return _combine(ye, expert_ids, gates, slot), aux


def _shared_experts(sh: Params, xg: torch.Tensor) -> torch.Tensor:
    """Qwen2-MoE's always-on shared experts of the groups xg (G, Sg, D)."""
    hgu_s = torch.einsum("gsd,dkf->gskf", xg, sh["w_gu"])
    hs = F.silu(hgu_s[:, :, 0].float()).to(xg.dtype) * hgu_s[:, :, 1]
    return hs @ sh["w_down"]
