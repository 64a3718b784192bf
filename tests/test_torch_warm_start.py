"""The port's warm-start pipeline, re-pointed from ``tests/test_warm_start.py``:
cross-group residency reuse, resume-aware cost predictions, fused-suffix
execution, and cost-aware group ordering.

The contract under test: warmth and fusion change *what gets loaded and
dispatched*, never *what gets computed* — outputs stay identical to cold
per-group serving, and every counter matches the cost model exactly
(``predicted_stats(..., resume=...)`` / ``predicted_group_stats``).  The
reference's ``resolve_interpret`` test has no counterpart: a port kernel
wrapper launches its kernel on a CUDA tensor and runs its plain version on
a CPU one, with no interpret switch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    BlockCost, GraphCostModel, MSP430, MultitaskProgram, TaskGraphExecutor,
    greedy_2opt_order, held_karp_order,
)
from repro_torch.core.task_graph import TaskGraph, enumerate_task_graphs
from repro_torch.core.types import ExecutionStats
from repro_torch.serving import (
    MultitaskEngine, MultitaskRequest, RequestGroupScheduler, order_groups,
)

DIM = 8


def _block(p, x):
    return torch.tanh(x @ p)


def _block_alt(p, x):
    return torch.sin(x @ p)


def _head(p, x):
    return x @ p


def _program(graph, dim=DIM, seed=0, heterogeneous=False):
    rng = np.random.default_rng(seed)
    costs = [BlockCost(weight_bytes=100.0 * (d + 1), flops=10.0 * (d + 1))
             for d in range(graph.depth)]
    fns = [_block] * graph.depth
    if heterogeneous:
        # Distinct fn objects per depth -> the fused path must fall back to
        # the unrolled (still single-dispatch) program.
        fns = [_block if d % 2 == 0 else _block_alt for d in range(graph.depth)]
    node_params = {
        node: torch.tensor(rng.normal(size=(dim, dim)), dtype=torch.float32)
        for node in graph.nodes()
    }
    head_params = [
        torch.tensor(rng.normal(size=(dim, 3)), dtype=torch.float32)
        for _ in range(graph.num_tasks)
    ]
    return MultitaskProgram(
        graph, fns, node_params, [_head] * graph.num_tasks, head_params, costs
    )


def _random_cases(seed=0, n_cases=6):
    rng = np.random.default_rng(seed)
    graphs = enumerate_task_graphs(4, 2)
    idx = rng.choice(len(graphs), size=min(n_cases, len(graphs)),
                     replace=False)
    for k, gi in enumerate(idx):
        yield k, graphs[int(gi)], rng


# --------------------------------------------------------------------------
# Executor: warm resumes + resume-aware predictions
# --------------------------------------------------------------------------

def test_warm_run_batch_stats_match_resume_prediction():
    for k, graph, rng in _random_cases(seed=3):
        prog = _program(graph, seed=k)
        cm = GraphCostModel(graph, prog.block_costs, MSP430)
        ex = TaskGraphExecutor(prog)
        cumulative = ExecutionStats()
        plan = []
        for _g in range(3):
            order = list(rng.permutation(graph.num_tasks))
            b = int(rng.integers(1, 5))
            xs = torch.tensor(rng.normal(size=(b, DIM)), dtype=torch.float32)
            resume = ex.residency_state()
            _, stats = ex.run_batch(xs, order)  # no reset: warm
            assert stats == cm.predicted_stats(order, batch_size=b,
                                               resume=resume)
            cumulative = cumulative.merge(stats)
            plan.append((order, b))
        assert cumulative == cm.predicted_group_stats(plan)


def test_warm_outputs_identical_to_cold():
    for k, graph, rng in _random_cases(seed=4):
        prog = _program(graph, seed=k)
        ex = TaskGraphExecutor(prog)
        cold = TaskGraphExecutor(prog)
        for _g in range(3):
            order = list(rng.permutation(graph.num_tasks))
            b = int(rng.integers(1, 5))
            xs = torch.tensor(rng.normal(size=(b, DIM)), dtype=torch.float32)
            warm_out, _ = ex.run_batch(xs, order)   # residency carried over
            cold.reset()
            cold_out, _ = cold.run_batch(xs, order)
            for t in order:
                np.testing.assert_allclose(
                    warm_out[t].numpy(), cold_out[t].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_set_residency_round_trips():
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]],
    ])
    prog = _program(graph)
    ex = TaskGraphExecutor(prog)
    xs = torch.ones((2, DIM))
    ex.run_batch(xs, [0, 2])
    state = ex.residency_state()
    assert state == tuple(graph.path(2))  # last task's full path resident

    other = TaskGraphExecutor(prog)
    other.set_residency(state)
    assert other.residency_state() == state
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    _, stats = other.run_batch(xs, [3, 1])
    assert stats == cm.predicted_stats([3, 1], batch_size=2, resume=state)
    with pytest.raises(ValueError):
        other.set_residency(state[:-1])


def test_predicted_stats_rejects_bad_resume_length():
    graph = TaskGraph.fully_shared(3, 2)
    prog = _program(graph, seed=1)
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    with pytest.raises(ValueError):
        cm.predicted_stats([0, 1, 2], resume=(None,))
    with pytest.raises(ValueError):
        cm.predicted_group_stats([([0], 1)], resume=(None,))


# --------------------------------------------------------------------------
# Fused-suffix execution
# --------------------------------------------------------------------------

@pytest.mark.parametrize("heterogeneous", [False, True])
def test_fused_matches_per_block_reference(heterogeneous):
    for k, graph, rng in _random_cases(seed=5):
        prog = _program(graph, seed=k, heterogeneous=heterogeneous)
        fused = TaskGraphExecutor(prog)
        ref = TaskGraphExecutor(prog, fused=False)
        for _g in range(2):  # second round runs warm
            order = list(rng.permutation(graph.num_tasks))
            b = int(rng.integers(1, 4))
            xs = torch.tensor(rng.normal(size=(b, DIM)), dtype=torch.float32)
            d0 = fused.dispatch_count
            out_f, stats_f = fused.run_batch(xs, order)
            # One dispatch per task: the whole suffix + head is one program.
            assert fused.dispatch_count - d0 == len(order)
            d0 = ref.dispatch_count
            out_r, stats_r = ref.run_batch(xs, order)
            assert ref.dispatch_count - d0 > len(order)
            assert stats_f == stats_r  # accounting is dispatch-mode blind
            for t in order:
                np.testing.assert_allclose(
                    out_f[t].numpy(), out_r[t].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_fused_single_request_path():
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]],
    ])
    prog = _program(graph, seed=6)
    fused = TaskGraphExecutor(prog)
    ref = TaskGraphExecutor(prog, fused=False)
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32)
    out_f, stats_f = fused.run(x, [2, 3, 0, 1])
    out_r, stats_r = ref.run(x, [2, 3, 0, 1])
    assert stats_f == stats_r
    for t in range(4):
        np.testing.assert_allclose(
            out_f[t].numpy(), out_r[t].numpy(),
            rtol=1e-5, atol=1e-6)


def test_fused_head_only_suffix():
    """Tasks sharing their full block path (split only at the heads) resume
    at depth == graph.depth: the fused program is just the head."""
    graph = TaskGraph.from_groups([
        [[0, 1, 2]], [[0], [1, 2]], [[0], [1, 2]],
    ])
    prog = _program(graph, seed=7)
    ex = TaskGraphExecutor(prog)
    xs = torch.ones((3, DIM))
    d0 = ex.dispatch_count
    out, stats = ex.run_batch(xs, [1, 2])  # task 2 shares 1's entire path
    assert ex.dispatch_count - d0 == 2
    assert stats.blocks_skipped == graph.depth  # full-path activation reuse
    ref = TaskGraphExecutor(prog, fused=False)
    out_r, _ = ref.run_batch(xs, [1, 2])
    for t in (1, 2):
        np.testing.assert_allclose(
            out[t].numpy(), out_r[t].numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Cost model: warm switching / group ordering building blocks
# --------------------------------------------------------------------------

def test_warm_switching_cost_is_load_only():
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]],
    ])
    prog = _program(graph)
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    for i in range(4):
        for j in range(4):
            warm = cm.warm_switching_cost(i, j)
            full = cm.switching_cost(i, j)
            if graph.shared_prefix_depth(i, j) == graph.depth:
                # Full-path sharing (same task, or tasks split only at the
                # heads): everything is resident, nothing loads.
                assert warm == full == 0.0
            else:
                assert 0.0 < warm < full  # loads only, no exec component
            # Equivalent to the residency-snapshot form.
            resident = tuple(graph.path(i))
            assert warm == pytest.approx(cm.resume_load_cost(resident, j))


def test_greedy_2opt_matches_exact_on_small_instances():
    rng = np.random.default_rng(8)
    for _ in range(10):
        n = int(rng.integers(3, 8))
        # Metric-like instances (the group matrices derive from tree prefix
        # sharing, so they are near-metric): 2-opt should hit the optimum.
        pts = rng.uniform(0.0, 1.0, size=(n, 2))
        c = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
        exact = held_karp_order(c)
        heur = greedy_2opt_order(c)
        assert sorted(heur.order) == list(range(n))
        assert heur.cost <= exact.cost + 1e-9
        # Unstructured asymmetric matrices: heuristic, but bounded.
        c = rng.uniform(0.1, 10.0, size=(n, n))
        np.fill_diagonal(c, 0.0)
        heur = greedy_2opt_order(c)
        assert sorted(heur.order) == list(range(n))
        assert heur.cost <= held_karp_order(c).cost * 1.5 + 1e-9


def test_order_groups_reduces_predicted_boundary_loads():
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3, 4, 5]],
        [[0, 1, 2], [3, 4, 5]],
        [[0, 1], [2], [3], [4, 5]],
        [[0], [1], [2], [3], [4], [5]],
    ])
    prog = _program(graph, seed=9)
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    order = tuple(range(6))
    rng = np.random.default_rng(9)
    # Alternating subtrees: the worst bucket order for warm hand-over.
    subsets = [(0, 1), (3, 4), (0, 2), (4, 5), (1, 2), (3, 5)]
    reqs = [MultitaskRequest(
        x=torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32), tasks=s)
        for s in subsets]
    sched = RequestGroupScheduler(batch_shapes=(1,))
    groups = sched.plan(reqs, num_tasks=6)

    def total_loads(seq):
        plan = [([t for t in order if t in g.tasks], g.valid) for g in seq]
        return cm.predicted_group_stats(plan).weight_bytes_loaded

    ordered = order_groups(groups, cm, order)
    assert sorted(g.indices for g in ordered) == sorted(
        g.indices for g in groups)  # a permutation, nothing dropped
    assert total_loads(ordered) < total_loads(groups)


def test_order_groups_keeps_empty_subset_groups_out_of_the_tsp():
    """A tasks=() group executes nothing: residency flows through it, so it
    must not act as a free waypoint between expensive neighbours — it goes
    to the back and the real groups are ordered among themselves."""
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2], [3]],
    ])
    prog = _program(graph, seed=13)
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    order = (0, 1, 2, 3)
    rng = np.random.default_rng(13)
    subsets = [(0,), (), (2,), (1,), (3,)]
    reqs = [MultitaskRequest(
        x=torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32), tasks=s)
        for s in subsets]
    groups = RequestGroupScheduler(batch_shapes=(1,)).plan(reqs, num_tasks=4)
    ordered = order_groups(groups, cm, order)
    assert ordered[-1].tasks == frozenset()
    # The real groups pair up by subtree: {0},{1} adjacent and {2},{3}
    # adjacent in some rotation — never interleaved across the empty group.
    seq = [min(g.tasks) for g in ordered[:-1]]
    pairs = {tuple(sorted(seq[i:i + 2])) for i in (0, 2)}
    assert pairs == {(0, 1), (2, 3)}


def test_order_groups_uses_initial_residency():
    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2], [3]],
    ])
    prog = _program(graph, seed=10)
    cm = GraphCostModel(graph, prog.block_costs, MSP430)
    order = (0, 1, 2, 3)
    rng = np.random.default_rng(10)
    reqs = [MultitaskRequest(
        x=torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32), tasks=s)
        for s in [(2,), (1,)]]
    groups = RequestGroupScheduler(batch_shapes=(1,)).plan(reqs, num_tasks=4)
    # Warm from task 1's path: its neighbour subset (1,) should go first.
    resident = tuple(graph.path(1))
    ordered = order_groups(groups, cm, order, initial_resident=resident)
    assert ordered[0].tasks == frozenset({1})
    # Warm from task 2's path: the other way around.
    resident = tuple(graph.path(2))
    ordered = order_groups(groups, cm, order, initial_resident=resident)
    assert ordered[0].tasks == frozenset({2})


# --------------------------------------------------------------------------
# Engine: warm serving end to end
# --------------------------------------------------------------------------

GRAPH6 = TaskGraph.from_groups([
    [[0, 1, 2, 3, 4, 5]],
    [[0, 1, 2], [3, 4, 5]],
    [[0, 1], [2], [3], [4, 5]],
    [[0], [1], [2], [3], [4], [5]],
])


def _requests(rng, subsets):
    return [MultitaskRequest(
        x=torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32), tasks=s)
        for s in subsets]


def test_engine_warm_matches_cold_and_predictions():
    prog = _program(GRAPH6, seed=11)
    rng = np.random.default_rng(11)
    subsets = [(0, 1), (3, 4), (0, 1, 2), (3, 4, 5), (0, 2), (4, 5),
               None, (1,), (5,), None]
    reqs = _requests(rng, subsets)
    warm = MultitaskEngine(prog, hw=MSP430,
                           scheduler=RequestGroupScheduler(batch_shapes=(1, 2)))
    cold = MultitaskEngine(prog, hw=MSP430, warm_start=False,
                           group_ordering=False,
                           scheduler=RequestGroupScheduler(batch_shapes=(1, 2)))
    for round_idx in range(2):  # second round starts warm from the first
        groups = warm.plan_groups(reqs)
        pred = warm.predicted_group_stats(groups)
        warm_resp = warm.serve_batch(reqs)
        cold_resp = cold.serve_batch(reqs)
        assert warm.last_batch_stats == pred
        assert cold.last_batch_stats == cold.predicted_group_stats(
            cold.plan_groups(reqs))
        assert (warm.last_batch_stats.weight_bytes_loaded
                < cold.last_batch_stats.weight_bytes_loaded)
        assert any(r.warm_weight_bytes_saved > 0 for r in warm_resp)
        for rw, rc in zip(warm_resp, cold_resp):
            assert set(rw.outputs) == set(rc.outputs)
            assert rw.predicted_seconds > 0
            # Warm groups report the latency that actually ran: never more
            # than the cold estimate for the same group.
            assert rw.predicted_seconds <= rc.predicted_seconds + 1e-12
            for t in rw.outputs:
                np.testing.assert_allclose(
                    rw.outputs[t].numpy(), rc.outputs[t].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_engine_warm_with_gates_stays_exact_per_request():
    prog = _program(GRAPH6, seed=12)

    def gate(outputs):
        return bool(outputs[0][0] > 0)

    gates = {t: gate for t in range(1, 6)}
    order = list(range(6))
    warm = MultitaskEngine(prog, hw=MSP430, gates=gates, order=order)
    solo = MultitaskEngine(prog, hw=MSP430, gates=gates, order=order,
                           warm_start=False, group_ordering=False,
                           scheduler=RequestGroupScheduler(batch_shapes=(1,)))
    rng = np.random.default_rng(12)
    reqs = _requests(rng, [None] * 6)
    for rw, req in zip(warm.serve_batch(reqs), reqs):
        rs = solo.serve(req)
        assert set(rw.outputs) == set(rs.outputs)
        for t in rw.outputs:
            np.testing.assert_allclose(
                rw.outputs[t].numpy(), rs.outputs[t].numpy(),
                rtol=1e-5, atol=1e-6)
