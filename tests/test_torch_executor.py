"""The port's block-cached executor against the JAX package's.

The same programs (weights carried over as numpy arrays), graphs, orders,
batches and residency go through both executors.  ``ExecutionStats``,
``dispatch_count``, residency and the gate trace are equal exactly (logical
counters); the fused dispatch mode ("scan" / "unrolled") is the same per
compile key; outputs agree to 1e-5 (fp32 products summed in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as r_ex
from repro.core import task_graph as r_tg
from repro.core.types import BlockCost as RBlockCost
from repro.models import multitask as r_mt
from repro_torch.core import executor as p_ex
from repro_torch.core import task_graph as p_tg
from repro_torch.core.types import BlockCost as PBlockCost
from repro_torch.models import multitask as p_mt

TOL = dict(rtol=1e-5, atol=1e-5)
GRAPHS = r_tg.enumerate_task_graphs(4, 2)


def _dense_programs(graph, dim=8, seed=0):
    """The homogeneous dense program of ``tests/test_executor.py`` in both
    packages, with equal weights."""
    rng = np.random.default_rng(seed)
    costs = [(100.0 * (d + 1), 10.0 * (d + 1)) for d in range(graph.depth)]
    nodes = {n: rng.normal(size=(dim, dim)).astype(np.float32) for n in graph.nodes()}
    heads = [rng.normal(size=(dim, 3)).astype(np.float32) for _ in range(graph.num_tasks)]

    def r_block(p, x):
        return jnp.tanh(x @ p)

    def p_block(p, x):
        return torch.tanh(x @ p)

    ref = r_ex.MultitaskProgram(
        graph, [r_block] * graph.depth, {n: jnp.asarray(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * graph.num_tasks, [jnp.asarray(h) for h in heads],
        [RBlockCost(weight_bytes=w, flops=f) for w, f in costs],
    )
    port = p_ex.MultitaskProgram(
        p_tg.TaskGraph(graph.num_tasks, graph.partitions), [p_block] * graph.depth,
        {n: torch.tensor(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * graph.num_tasks, [torch.tensor(h) for h in heads],
        [PBlockCost(weight_bytes=w, flops=f) for w, f in costs],
    )
    return ref, port


def _cnn_programs(graph, num_classes):
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(1), graph, num_classes)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    port = p_mt.program_from_reference(
        p_tg.TaskGraph(graph.num_tasks, graph.partitions),
        np_tree(ref.node_params), np_tree(ref.head_params), device="cpu",
    )
    return ref, port


def _modes(ref_ex, port_ex):
    ref = {k[:4]: mode for k, (_f, mode) in ref_ex._compiled_fused.items()}
    port = {k[:4]: mode for k, (_f, mode) in port_ex._compiled_fused.items()}
    return ref, port


def _assert_same(ref_result, port_result, ref_ex, port_ex):
    (r_out, r_stats), (p_out, p_stats) = ref_result, port_result
    assert dataclasses.asdict(r_stats) == dataclasses.asdict(p_stats)
    assert set(r_out) == set(p_out)
    for t in r_out:
        np.testing.assert_allclose(p_out[t].numpy(), np.asarray(r_out[t]), **TOL)
    assert ref_ex.dispatch_count == port_ex.dispatch_count
    assert ref_ex.residency_state() == port_ex.residency_state()
    assert [dataclasses.asdict(r) for r in ref_ex.last_trace] == [
        dataclasses.asdict(r) for r in port_ex.last_trace
    ]
    ref_modes, port_modes = _modes(ref_ex, port_ex)
    assert ref_modes == port_modes


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_run_matches_reference_cold_and_warm(seed, fused):
    rng = np.random.default_rng(seed)
    graph = GRAPHS[int(rng.integers(len(GRAPHS)))]
    ref_prog, port_prog = _dense_programs(graph, seed=seed)
    ref_ex, port_ex = r_ex.TaskGraphExecutor(ref_prog, fused=fused), p_ex.TaskGraphExecutor(
        port_prog, fused=fused)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    for _ in range(3):  # cold, then warm: residency carries, activations do not
        order = [int(t) for t in rng.permutation(4)]
        _assert_same(ref_ex.run(jnp.asarray(x), order),
                     port_ex.run(torch.as_tensor(x), order), ref_ex, port_ex)
    ref_ex.reset()
    port_ex.reset()
    order = [3, 0, 2, 1]
    _assert_same(ref_ex.run(jnp.asarray(x), order),
                 port_ex.run(torch.as_tensor(x), order), ref_ex, port_ex)
    if fused:
        assert "scan" in set(_modes(ref_ex, port_ex)[1].values()) or graph.depth < 2


@pytest.mark.parametrize("sample", [(8,), (2, 8)])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_run_batch_matches_reference(seed, fused, sample):
    rng = np.random.default_rng(100 + seed)
    graph = GRAPHS[int(rng.integers(len(GRAPHS)))]
    ref_prog, port_prog = _dense_programs(graph, seed=seed)
    ref_ex, port_ex = r_ex.TaskGraphExecutor(ref_prog, fused=fused), p_ex.TaskGraphExecutor(
        port_prog, fused=fused)
    for batch, valid in ((4, 3), (1, 1), (4, 4)):
        xs = rng.standard_normal((batch, *sample)).astype(np.float32)
        order = [int(t) for t in rng.permutation(4)][: int(rng.integers(1, 5))]
        _assert_same(
            ref_ex.run_batch(jnp.asarray(xs), order, valid=valid),
            port_ex.run_batch(torch.as_tensor(xs), order, valid=valid),
            ref_ex, port_ex,
        )


def test_group_gate_matches_reference():
    graph = GRAPHS[-1]
    ref_prog, port_prog = _dense_programs(graph)
    ref_ex, port_ex = r_ex.TaskGraphExecutor(ref_prog), p_ex.TaskGraphExecutor(port_prog)

    def gate(task, outputs):
        return task != 2 and (task == 0 or 0 in outputs)

    xs = np.random.default_rng(5).standard_normal((4, 8)).astype(np.float32)
    _assert_same(ref_ex.run_batch(jnp.asarray(xs), [0, 1, 2, 3], gate, valid=3),
                 port_ex.run_batch(torch.as_tensor(xs), [0, 1, 2, 3], gate, valid=3),
                 ref_ex, port_ex)
    _assert_same(ref_ex.run(jnp.asarray(xs[0]), [1, 2, 3, 0], gate),
                 port_ex.run(torch.as_tensor(xs[0]), [1, 2, 3, 0], gate),
                 ref_ex, port_ex)


@pytest.mark.parametrize("fused", [True, False])
def test_lenet_program_matches_reference(fused):
    graph = r_tg.TaskGraph.from_groups(
        [[[0, 1, 2]], [[0, 1], [2]], [[0, 1], [2]], [[0], [1], [2]]])
    ref_prog, port_prog = _cnn_programs(graph, [4, 3, 5])
    ref_ex, port_ex = r_ex.TaskGraphExecutor(ref_prog, fused=fused), p_ex.TaskGraphExecutor(
        port_prog, fused=fused)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((4, 1, 28, 28, 1)).astype(np.float32)
    _assert_same(ref_ex.run_batch(jnp.asarray(xs), [2, 0, 1], valid=3),
                 port_ex.run_batch(torch.as_tensor(xs), [2, 0, 1], valid=3),
                 ref_ex, port_ex)
    x = rng.standard_normal((3, 28, 28, 1)).astype(np.float32)
    _assert_same(ref_ex.run(jnp.asarray(x), [0, 1, 2]),
                 port_ex.run(torch.as_tensor(x), [0, 1, 2]), ref_ex, port_ex)
    if fused:
        assert set(_modes(ref_ex, port_ex)[1].values()) == {"unrolled"}


def test_vanilla_matches_reference():
    graph = GRAPHS[-1]
    ref_prog, port_prog = _dense_programs(graph)
    x = np.ones((2, 8), np.float32)
    _o, r_stats = r_ex.VanillaExecutor(ref_prog).run(jnp.asarray(x), [2, 0, 3, 1])
    _o, p_stats = p_ex.VanillaExecutor(port_prog).run(torch.as_tensor(x), [2, 0, 3, 1])
    assert dataclasses.asdict(r_stats) == dataclasses.asdict(p_stats)
    _o, p_run = p_ex.run_in_order(port_prog, torch.as_tensor(x), [2, 0, 3, 1])
    _o, r_run = r_ex.run_in_order(ref_prog, jnp.asarray(x), [2, 0, 3, 1])
    assert dataclasses.asdict(r_run) == dataclasses.asdict(p_run)


def test_set_residency_and_fused_toggle():
    ref_prog, port_prog = _dense_programs(GRAPHS[-1])
    ex = p_ex.TaskGraphExecutor(port_prog)
    state = tuple(port_prog.graph.path(1))
    ex.set_residency(state)
    assert ex.residency_state() == state
    with pytest.raises(ValueError):
        ex.set_residency(state[:-1])
    ex.fused = False
    _out, stats = ex.run(torch.ones(2, 8), [1])
    assert stats.weight_bytes_loaded == 0.0 and ex.dispatch_count == port_prog.graph.depth + 1


def _one_block_programs(block):
    graph = p_tg.TaskGraph.fully_shared(2, 2)
    rng = np.random.default_rng(0)
    return p_ex.MultitaskProgram(
        graph, [block] * 3,
        {n: torch.tensor(rng.normal(size=(8, 8)).astype(np.float32)) for n in graph.nodes()},
        [lambda p, x: x @ p] * 2,
        [torch.ones(8, 3), torch.ones(8, 3)],
        [PBlockCost(weight_bytes=1.0, flops=1.0)] * 3,
    )


def test_value_dependent_block_is_unrolled():
    """A block fn that reads values cannot run on meta tensors: the probe
    reports "not scannable", as the reference's does for tracer errors."""

    def block(p, x):
        if float(x.sum()) >= 0:
            return torch.tanh(x @ p)
        return torch.tanh(x @ p) * 0.5

    ex = p_ex.TaskGraphExecutor(_one_block_programs(block))
    out, _ = ex.run(torch.ones(8), [0, 1])
    assert set(out) == {0, 1}
    assert {mode for (_fn, mode) in ex._compiled_fused.values()} == {"unrolled"}


def test_real_block_bug_propagates():
    def block(p, x):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        p_ex.TaskGraphExecutor(_one_block_programs(block)).run(torch.ones(8), [0, 1])
