"""The port's MoE layer against the JAX package's.

The same weights (the reference's ``init_moe_mlp``, carried over as numpy
arrays) and the same inputs go through both packages.  Routing is
discontinuous, so the router is checked first on bit-equal logits (expert
ids exact, gates to the last bits), the dispatch table against a plain loop over the
stable order, then the layer's outputs and aux loss at fp32 1e-5 / 2e-5:
with and without shared experts, at a capacity factor that drops entries
and at one that drops none, with the batch pooled into one group (S < 64)
and with one group per row, and with padding experts that are never chosen.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import moe as r_moe
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.models import moe as p_moe
from repro_torch.models import multitask as p_mt

P = TP_POLICY
FP32 = dict(rtol=1e-5, atol=2e-5)
ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")  # with shared experts, without
R_MOE_MLP = jax.jit(r_moe.moe_mlp, static_argnums=(2, 3))  # compiled once per shape


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (dataclasses.replace(r_configs.get_smoke_config(arch), **kw),
            dataclasses.replace(p_configs.get_smoke_config(arch), **kw))


def _layer(arch, seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    rp = jax.jit(r_moe.init_moe_mlp, static_argnums=1)(jax.random.PRNGKey(seed), rcfg)
    return rcfg, pcfg, rp, p_mt.params_from_reference(_np_tree(rp), device="cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dispatch_loop(ids: np.ndarray, e: int, cap: int):
    """The dispatch table by a plain loop: within each group, experts in
    ascending order, each expert's choices in token order (the stable sort
    by expert), the first ``cap`` kept."""
    g, s, k = ids.shape
    table = np.full((g, e, cap), s)
    slot = np.full((g, s, k), e * cap)
    for gi in range(g):
        for ex in range(e):
            rank = 0
            for t in range(s):
                for j in range(k):
                    if ids[gi, t, j] == ex:
                        if rank < cap:
                            table[gi, ex, rank] = t
                            slot[gi, t, j] = ex * cap + rank
                        rank += 1
    return table, slot


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-moe-a2.7b", {}), ("mixtral-8x22b", {}),
    ("qwen2-moe-a2.7b", {"moe_num_experts": 6, "moe_real_experts": 4}),
])
def test_route_is_exact_on_bit_equal_logits(arch, kw):
    """The reference's logits fed to both routers' tails (through an
    identity router, which reproduces them bit for bit): the same expert
    ids; gates and router probabilities within two fp32 ulps (XLA's and
    PyTorch's ``exp`` differ in the last bit); padding experts never
    chosen and of probability 0."""
    rcfg, pcfg, rp, pp = _layer(arch, **kw)
    x = _x((3, 40, rcfg.d_model), seed=1)
    logits = np.array(jnp.asarray(x) @ rp["router"])
    e = rcfg.moe_num_experts
    r_ids, r_gates, r_probs = r_moe._route(jnp.eye(e, dtype=jnp.float32), jnp.asarray(logits), rcfg)
    ids, gates, probs = p_moe.route_logits(torch.as_tensor(logits), pcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(r_gates), rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(r_probs), rtol=2.5e-7, atol=1e-12)
    real = rcfg.moe_real_experts or e
    assert int(ids.max()) < real and not probs[..., real:].any()
    # The whole router, logits included, as the layer calls it.
    ids2, gates2, _ = p_moe._route(pp["router"], torch.as_tensor(x), pcfg)
    np.testing.assert_array_equal(ids2.numpy(), ids.numpy())
    np.testing.assert_allclose(gates2.numpy(), gates.numpy(), rtol=1e-5, atol=1e-6)


def test_load_balance_loss_matches_reference():
    rcfg, pcfg, _rp, _pp = _layer("qwen2-moe-a2.7b")
    rng = np.random.default_rng(2)
    probs = rng.dirichlet(np.ones(4), size=(2, 9)).astype(np.float32)
    ids = np.stack([rng.permutation(4)[:2] for _ in range(18)]).reshape(2, 9, 2)
    ref = r_moe.load_balance_loss(jnp.asarray(probs), jnp.asarray(ids), rcfg)
    out = p_moe.load_balance_loss(torch.as_tensor(probs), torch.as_tensor(ids), pcfg)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("cap", [1, 3, 6, 40])
def test_dispatch_matches_a_plain_loop(cap):
    """Ranks from the stable sort and a left searchsorted: the earliest
    choices of each expert keep its ``cap`` slots, the rest drop."""
    rng = np.random.default_rng(cap)
    ids = np.stack([rng.permutation(6)[:3] for _ in range(2 * 17)]).reshape(2, 17, 3)
    table, slot = p_moe.dispatch(torch.as_tensor(ids), 6, cap)
    want_table, want_slot = _dispatch_loop(ids, 6, cap)
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(slot.numpy(), want_slot)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("b,s", [(3, 16), (2, 70)])
def test_moe_mlp_matches_reference(arch, cf, b, s):
    """Outputs and aux loss; at cf 1.0 some choices drop (the same ones in
    both packages, or the outputs would differ by whole expert outputs), at
    cf 8.0 none.  S < 64 pools the batch into one group."""
    rcfg, pcfg, rp, pp = _layer(arch, seed=3, moe_capacity_factor=cf)
    x = _x((b, s, rcfg.d_model), seed=4)
    ref_y, ref_aux = R_MOE_MLP(rp, jnp.asarray(x), rcfg, P)
    y, aux = p_moe.moe_mlp(pp, torch.as_tensor(x), pcfg)
    assert y.shape == (b, s, pcfg.d_model) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **FP32)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    xg = torch.as_tensor(x) if s >= 64 else torch.as_tensor(x).reshape(1, b * s, -1)
    ids, _g, _p = p_moe._route(pp["router"], xg, pcfg)
    cap = p_moe.capacity(xg.shape[1], pcfg)
    _table, slot = p_moe.dispatch(ids, pcfg.moe_num_experts, cap)
    dropped = int((slot == pcfg.moe_num_experts * cap).sum())
    assert (dropped > 0) == (cf == 1.0), dropped


@pytest.mark.parametrize("s", [16, 70])
def test_short_sequences_pool_the_batch_for_routing(s):
    """Below 64 tokens the whole batch is one routing group in both
    packages, so zero padding rows (router logits 0, ties broken to the
    lowest experts) compete with a real row for capacity and change its
    output (by 0.602 at S 16); at S 70 each row is its own group and a real
    row's output does not depend on what is batched with it."""
    rcfg, pcfg, rp, pp = _layer("qwen2-moe-a2.7b", seed=0)
    x = _x((1, s, rcfg.d_model), seed=0)
    padded = np.concatenate([x, np.zeros((3, s, rcfg.d_model), np.float32)])
    gaps = []
    for run in (lambda v: np.asarray(R_MOE_MLP(rp, jnp.asarray(v), rcfg, P)[0]),
                lambda v: p_moe.moe_mlp(pp, torch.as_tensor(v), pcfg)[0].numpy()):
        gaps.append(float(np.abs(run(padded)[0] - run(x)[0]).max()))
    assert gaps[1] == pytest.approx(gaps[0], abs=2e-5)
    if s < 64:
        assert gaps[0] == pytest.approx(0.602, abs=1e-3)
    else:
        assert gaps[0] == 0.0


def test_padding_experts_are_never_chosen():
    """``moe_real_experts`` < E (the reference's expert-parallel padding):
    the padded experts' weights exist but no token reaches them."""
    rcfg, pcfg, rp, pp = _layer("qwen2-moe-a2.7b", seed=5, moe_num_experts=6,
                                moe_real_experts=4)
    assert pp["w_gu"].shape[0] == 6
    x = _x((2, 70, rcfg.d_model), seed=6)
    ref_y, ref_aux = R_MOE_MLP(rp, jnp.asarray(x), rcfg, P)
    y, aux = p_moe.moe_mlp(pp, torch.as_tensor(x), pcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **FP32)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    table, _slot = p_moe.dispatch(p_moe._route(pp["router"], torch.as_tensor(x), pcfg)[0], 6,
                                  p_moe.capacity(70, pcfg))
    assert bool((table[:, 4:] == 70).all())  # every padded expert's slots empty
    zeroed = {**pp, "w_gu": pp["w_gu"].clone(), "w_down": pp["w_down"].clone()}
    zeroed["w_gu"][4:] = 0
    zeroed["w_down"][4:] = 0
    assert torch.equal(p_moe.moe_mlp(zeroed, torch.as_tensor(x), pcfg)[0], y)


def test_init_draws_reference_layouts():
    for arch in ARCHS:
        rcfg, pcfg = _cfgs(arch)
        ref = jax.eval_shape(lambda: r_moe.init_moe_mlp(jax.random.PRNGKey(0), rcfg))
        port = p_moe.init_moe_mlp(torch.Generator().manual_seed(0), pcfg, torch.device("cpu"))
        shapes = lambda tree, f: jax.tree_util.tree_map(f, tree)  # noqa: E731
        assert shapes(port, lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch."))) == \
            shapes(ref, lambda a: (a.shape, str(a.dtype)))
        bound = 2.0 / np.sqrt(pcfg.d_model) + 1e-6  # truncated at 2 std
        assert float(port["router"].abs().max()) <= bound
        assert float(port["w_gu"].abs().max()) <= bound
        assert not torch.equal(port["w_gu"][:, :, 0], port["w_gu"][:, :, 1])
