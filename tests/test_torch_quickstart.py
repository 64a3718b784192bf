"""The quickstart's pieces in the port, held against the JAX package:
joint training (``program_with_params``, ``multitask_loss``, ``sgd_update``),
block profiling, the §6.1 baselines, the hardware presets, and the
quickstart's five steps end to end.  Also re-points the multitask part of
``tests/test_serving.py`` and ``tests/test_extensions.py::
test_profiler_produces_consistent_costs``.

Tolerances: fp32 1e-5 for the loss, the gradients and one SGD step.  The
end-to-end affinities of a short training run agree to 1e-4: the two
packages' fp32 Gram products differ in the last bits and Spearman ranks
near-ties by them.  Selection and ordering are compared given the same
affinity matrix, so a near-tie cannot flip them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hardware as r_hw
from repro.core import GAConfig as RGAConfig
from repro.core import GraphCostModel as RGraphCostModel
from repro.core import TaskGraph as RTaskGraph
from repro.core import baselines as r_base
from repro.core import genetic_order as r_genetic_order
from repro.core import optimal_order as r_optimal_order
from repro.core import types as r_types
from repro.core.affinity import affinity_matrix as r_affinity_matrix
from repro.core.affinity import profile_task as r_profile_task
from repro.core.profiler import profile_program_blocks as r_profile_program_blocks
from repro.core.tradeoff import select_task_graph as r_select_task_graph
from repro.models import multitask as r_mt
from repro.models.cnn import build_lenet5_blocks as r_lenet_blocks
from repro.training.optimizer import sgd_update as r_sgd_update
from repro_torch._device import tree_leaves
from repro_torch.configs import hardware as p_hw
from repro_torch.core import (
    Constraints, GraphCostModel, MSP430, TaskGraph, optimal_order,
)
from repro_torch.core import baselines as p_base
from repro_torch.core import types as p_types
from repro_torch.core.profiler import profile_program_blocks
from repro_torch.data import MultitaskDataset, train_test_split
from repro_torch.examples import quickstart as qs
from repro_torch.models import multitask as p_mt
from repro_torch.serving import MultitaskEngine, MultitaskRequest
from repro_torch.training import sgd_update

FP32 = dict(rtol=1e-5, atol=1e-5)
N_TASKS, N_CLASSES = qs.N_TASKS, qs.N_CLASSES


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _separate_programs(seed=0):
    """The quickstart's fully-separate LeNet-5 program in both packages,
    the reference's weights carried over."""
    graph = RTaskGraph.fully_separate(N_TASKS, 3)
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(seed), graph, [N_CLASSES] * N_TASKS)
    port = p_mt.program_from_reference(
        TaskGraph(graph.num_tasks, graph.partitions),
        _np_tree(ref.node_params), _np_tree(ref.head_params), device="cpu",
    )
    return ref, port


def _data():
    ds = MultitaskDataset(num_tasks=N_TASKS, num_classes=N_CLASSES, seed=0)
    return train_test_split(ds, 2048, 512)


def _flat_close(port_flat, ref_flat, tol=FP32):
    """Leaf by leaf, matched by key (JAX orders dict leaves by sorted key)."""
    if isinstance(ref_flat, dict):
        assert set(port_flat) == set(ref_flat)
        for k in ref_flat:
            _flat_close(port_flat[k], ref_flat[k], tol)
    elif isinstance(ref_flat, (list, tuple)):
        assert len(port_flat) == len(ref_flat)
        for p, r in zip(port_flat, ref_flat):
            _flat_close(p, r, tol)
    else:
        np.testing.assert_allclose(
            port_flat.detach().float().numpy(), np.asarray(ref_flat, np.float32), **tol)


# --------------------------------------------------------------------------
# Joint training: loss, gradients, one SGD step
# --------------------------------------------------------------------------

def test_trainable_params_round_trip():
    port = p_mt.build_cnn_program(
        TaskGraph.fully_separate(N_TASKS, 3), [N_CLASSES] * N_TASKS,
        generator=torch.Generator().manual_seed(0), device="cpu")
    flat = p_mt.program_trainable_params(port)
    rebuilt = p_mt.program_with_params(port, flat)
    assert rebuilt.node_params.keys() == port.node_params.keys()
    for k in port.node_params:
        assert rebuilt.node_params[k] is port.node_params[k]
    assert rebuilt.head_params == port.head_params
    assert rebuilt.block_costs == port.block_costs


@pytest.mark.parametrize("weighted", [False, True])
def test_multitask_loss_matches_reference(weighted):
    ref, port = _separate_programs()
    (xtr, ytr), _ = _data()
    x, y = xtr[:32], ytr[:, :32]
    w = np.array([1.0, 2.0, 0.5, 0.0, 3.0], np.float32) if weighted else None
    r_loss = r_mt.multitask_loss(ref, r_mt.program_trainable_params(ref), jnp.asarray(x),
                                 jnp.asarray(y), None if w is None else jnp.asarray(w))
    p_loss = p_mt.multitask_loss(port, p_mt.program_trainable_params(port),
                                 torch.as_tensor(x), torch.as_tensor(y),
                                 None if w is None else torch.as_tensor(w))
    assert p_loss.dtype == torch.float32 and p_loss.shape == ()
    np.testing.assert_allclose(float(p_loss), float(r_loss), **FP32)


def test_one_sgd_step_matches_reference():
    """Autograd's gradients and the updated parameters against
    ``jax.value_and_grad`` + the reference's ``sgd_update``."""
    ref, port = _separate_programs()
    (xtr, ytr), _ = _data()
    idx = np.random.default_rng(0).integers(0, xtr.shape[0], size=64)
    r_flat = r_mt.program_trainable_params(ref)
    r_loss, r_grads = jax.value_and_grad(
        lambda f: r_mt.multitask_loss(ref, f, jnp.asarray(xtr[idx]), jnp.asarray(ytr[:, idx]))
    )(r_flat)
    p_flat = p_mt.program_trainable_params(port)
    p_loss, p_grads = qs.loss_and_grads(
        port, p_flat, torch.as_tensor(xtr[idx]), torch.as_tensor(ytr[:, idx]))
    np.testing.assert_allclose(float(p_loss), float(r_loss), **FP32)
    _flat_close(p_grads, r_grads)
    _flat_close(sgd_update(qs.LR, p_grads, p_flat), r_sgd_update(qs.LR, r_grads, r_flat))
    # The step leaves the inputs alone and carries no autograd graph.
    _flat_close(p_flat, r_flat)
    assert not any(t.requires_grad for t in tree_leaves(sgd_update(qs.LR, p_grads, p_flat)))


def test_sgd_update_casts_back_in_fp32():
    params = {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16), "b": [torch.ones(3)]}
    grads = {"a": torch.tensor([0.5, 0.25]), "b": [torch.full((3,), 2.0)]}
    out = sgd_update(0.1, grads, params)
    ref = r_sgd_update(0.1, {"a": jnp.asarray([0.5, 0.25]), "b": [jnp.full((3,), 2.0)]},
                       {"a": jnp.asarray([1.0, 2.0], jnp.bfloat16), "b": [jnp.ones(3)]})
    assert out["a"].dtype == torch.bfloat16 and out["b"][0].dtype == torch.float32
    np.testing.assert_array_equal(out["a"].float().numpy(), np.asarray(ref["a"], np.float32))
    np.testing.assert_allclose(out["b"][0].numpy(), np.asarray(ref["b"][0]), **FP32)


# --------------------------------------------------------------------------
# Profiler, baselines, hardware presets
# --------------------------------------------------------------------------

def test_profiler_produces_consistent_costs():
    graph = TaskGraph.from_groups([[[0, 1]], [[0, 1]], [[0], [1]], [[0], [1]]])
    prog = p_mt.build_cnn_program(graph, [4, 4], generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    x = torch.ones((4, 28, 28, 1))
    costs = profile_program_blocks(prog, x, MSP430)
    assert len(costs) == graph.depth
    for c in costs:
        assert c.weight_bytes > 0 and c.flops > 0
    cm = GraphCostModel(graph, costs, MSP430)
    assert sorted(optimal_order(cm.cost_matrix()).order) == [0, 1]


def test_profiler_shape_arithmetic_matches_reference():
    """Bytes come from shapes and dtypes: equal to the reference's profile
    and to the analytic LeNet-5 table; flops are the clock's."""
    graph = RTaskGraph.from_groups([[[0, 1]], [[0, 1]], [[0], [1]], [[0], [1]]])
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(0), graph, [4, 4])
    port = p_mt.program_from_reference(
        TaskGraph(graph.num_tasks, graph.partitions),
        _np_tree(ref.node_params), _np_tree(ref.head_params), device="cpu")
    x = np.ones((4, 28, 28, 1), np.float32)
    r_costs = r_profile_program_blocks(ref, jnp.asarray(x), r_types.MSP430)
    p_costs = profile_program_blocks(port, torch.as_tensor(x), MSP430)
    _i, _a, table, _f = r_lenet_blocks()
    for r, p, t in zip(r_costs, p_costs, table):
        assert (p.weight_bytes, p.act_bytes) == (r.weight_bytes, r.act_bytes)
        assert (p.weight_bytes, p.act_bytes) == (t.weight_bytes, t.act_bytes)
        assert np.isfinite(p.flops) and p.flops > 0


@pytest.mark.parametrize("hw", ["MSP430", "STM32H747", "TPU_V5E"])
def test_baselines_match_reference(hw):
    r_h, p_h = getattr(r_types, hw), getattr(p_types, hw)
    _i, _a, costs, _f = r_lenet_blocks()
    p_costs = [p_types.BlockCost(**dataclasses.asdict(c)) for c in costs]
    for fn in ("vanilla_baseline", "nwv_baseline", "nws_baseline", "yono_baseline"):
        for n in (1, 5, 9):
            r_rep = getattr(r_base, fn)(n, costs, r_h)
            p_rep = getattr(p_base, fn)(n, p_costs, p_h)
            assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
    graph = RTaskGraph.from_groups([
        [[0, 1, 2, 3, 4]], [[0, 1, 2], [3, 4]], [[0, 1], [2], [3, 4]],
        [[0], [1], [2], [3], [4]],
    ])
    for order in ((0, 1, 2, 3, 4), (4, 2, 0, 3, 1)):
        r_rep = r_base.antler_report(graph, costs, r_h, order)
        p_rep = p_base.antler_report(
            TaskGraph(graph.num_tasks, graph.partitions), p_costs, p_h, order)
        assert dataclasses.asdict(p_rep) == dataclasses.asdict(r_rep)
        assert p_rep.seconds < p_base.vanilla_baseline(5, p_costs, p_h).seconds


def test_hardware_presets_match_reference():
    assert p_hw.list_hardware() == r_hw.list_hardware()
    for name in r_hw.list_hardware():
        assert dataclasses.asdict(p_hw.get_hardware(name)) == dataclasses.asdict(
            r_hw.get_hardware(name))
        assert p_hw.get_hardware(f" {name.upper()} ") is p_hw.HARDWARE[name]
    with pytest.raises(KeyError, match="unknown hardware"):
        p_hw.get_hardware("h100")


# --------------------------------------------------------------------------
# The engine on LeNet-5 (the multitask part of tests/test_serving.py)
# --------------------------------------------------------------------------

def _engine(gates=None, constraints=None, order=None):
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0, 1], [2, 3]], [[0], [1], [2], [3]],
    ])
    prog = p_mt.build_cnn_program(graph, [3] * 4, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    return MultitaskEngine(prog, constraints=constraints, hw=MSP430, gates=gates, order=order)


def _image(seed, batch):
    return torch.as_tensor(
        np.random.default_rng(seed).standard_normal((batch, 28, 28, 1)).astype(np.float32))


def test_engine_serves_all_tasks_and_counts():
    resp = _engine().serve(MultitaskRequest(x=_image(1, 2)))
    assert set(resp.outputs) == {0, 1, 2, 3}
    assert resp.stats.blocks_skipped > 0
    assert resp.predicted_seconds > 0


def test_engine_respects_precedence_order():
    eng = _engine(constraints=Constraints.make(4, precedence=[(3, 0)]))
    assert eng.order.index(3) < eng.order.index(0)


def test_engine_conditional_gate_skips():
    def dependent_gate(outputs):
        return bool(torch.argmax(outputs[0][0]) == 0)

    eng = _engine(gates={t: dependent_gate for t in (1, 2, 3)}, order=[0, 1, 2, 3])
    resp = eng.serve(MultitaskRequest(x=_image(2, 1)))
    if bool(torch.argmax(resp.outputs[0][0]) == 0):
        assert set(resp.outputs) == {0, 1, 2, 3}
    else:
        assert set(resp.outputs) == {0}
        assert resp.stats.tasks_skipped == 3


def test_engine_task_subset_requests():
    resp = _engine().serve(MultitaskRequest(x=_image(3, 1), tasks=[1, 2]))
    assert set(resp.outputs) == {1, 2}


# --------------------------------------------------------------------------
# The quickstart's steps against the reference
# --------------------------------------------------------------------------

def test_selection_and_orders_match_reference_given_one_affinity():
    """Steps 3-4 on one affinity matrix: the same selected graph, the same
    exact and GA orders and costs."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1, 1, size=(3, N_TASKS, N_TASKS)).astype(np.float32)
    aff = (a + a.transpose(0, 2, 1)) / 2
    for d in range(3):
        np.fill_diagonal(aff[d], 1.0)
    res, exact, ga = qs.select_and_order(aff, p_hw.get_hardware(qs.HARDWARE))
    _i, _a, costs, _f = r_lenet_blocks()
    r_res = r_select_task_graph(N_TASKS, 3, aff, costs, r_types.MSP430)
    cm = RGraphCostModel(r_res.selected.graph, costs, r_types.MSP430)
    r_exact = r_optimal_order(cm.cost_matrix())
    r_ga = r_genetic_order(cm.cost_matrix(), config=RGAConfig(seed=0))
    assert res.selected.graph.partitions == r_res.selected.graph.partitions
    assert len(res.candidates) == len(r_res.candidates)
    assert (exact.order, exact.cost) == (r_exact.order, r_exact.cost)
    assert (ga.order, ga.cost) == (r_ga.order, r_ga.cost)
    assert ga.cost >= exact.cost


def test_short_training_and_profile_match_reference():
    """Step 2 from the reference's initial weights, cut to 5 SGD steps:
    the losses, the trained parameters and the affinity tensor."""
    ref, port = _separate_programs()
    (xtr, ytr), (xte, _yte) = _data()
    steps = 5
    loss_grad = jax.jit(jax.value_and_grad(
        lambda f, x, y: r_mt.multitask_loss(ref, f, x, y)))
    r_flat = r_mt.program_trainable_params(ref)
    rng = np.random.default_rng(0)
    r_losses = []
    for _ in range(steps):
        idx = rng.integers(0, xtr.shape[0], size=qs.TRAIN_BATCH)
        loss, grads = loss_grad(r_flat, jnp.asarray(xtr[idx]), jnp.asarray(ytr[:, idx]))
        r_flat = r_sgd_update(qs.LR, grads, r_flat)
        r_losses.append(float(loss))
    p_flat, p_losses = qs.train(port, xtr, ytr, steps=steps)
    np.testing.assert_allclose(p_losses, r_losses, **FP32)
    _flat_close(p_flat, r_flat, tol=dict(rtol=1e-4, atol=1e-5))

    trained = r_mt.program_with_params(ref, r_flat)
    probe = jnp.asarray(xte[:qs.N_PROBES])
    r_profiles = []
    for t in range(N_TASKS):
        taps, h = [], probe
        for d, node in enumerate(trained.graph.path(t)):
            h = trained.block_fns[d](trained.node_params[node], h)
            if d < 3:
                taps.append(h.reshape(h.shape[0], -1))
        r_profiles.append(r_profile_task(taps))
    r_aff = np.asarray(r_affinity_matrix(r_profiles))
    p_aff = qs.profile(p_mt.program_with_params(port, p_flat),
                       torch.as_tensor(xte[:qs.N_PROBES]))
    assert p_aff.shape == (3, N_TASKS, N_TASKS)
    np.testing.assert_allclose(p_aff, r_aff, rtol=0, atol=1e-4)


def test_quickstart_runs_on_the_cpu(capsys):
    out = qs.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for step in range(1, 6):
        assert f"== {step}." in text
    assert out["device"] == "cpu"
    assert len(out["losses"]) == qs.TRAIN_STEPS
    assert out["losses"][-1] < out["losses"][0]
    aff = out["aff"]
    assert aff.shape == (3, N_TASKS, N_TASKS) and np.isfinite(aff).all()
    np.testing.assert_allclose(aff, aff.transpose(0, 2, 1), atol=1e-6)
    assert out["ga"].cost >= out["exact"].cost
    hw = p_hw.get_hardware(qs.HARDWARE)
    assert out["antler"].seconds(hw) < out["vanilla"].seconds(hw)
    assert out["antler"].blocks_executed < out["vanilla"].blocks_executed
    assert out["antler_report"].seconds < out["vanilla_report"].seconds


def test_quickstart_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.main([])
