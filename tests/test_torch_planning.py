"""The port's framework-free planning core equals the JAX package's.

``repro_torch.core.{types, constraints, task_graph, cost_model, ordering,
genetic, tradeoff}`` and ``repro_torch.data.synthetic`` are copies of their
reference modules: on the same inputs every result is *exactly* equal (no
tolerance — the arithmetic is the same Python and numpy).
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import constraints as r_cons
from repro.core import cost_model as r_cm
from repro.core import genetic as r_ga
from repro.core import ordering as r_ord
from repro.core import task_graph as r_tg
from repro.core import tradeoff as r_tr
from repro.core import types as r_types
from repro.data import synthetic as r_syn
from repro_torch.core import constraints as p_cons
from repro_torch.core import cost_model as p_cm
from repro_torch.core import genetic as p_ga
from repro_torch.core import ordering as p_ord
from repro_torch.core import task_graph as p_tg
from repro_torch.core import tradeoff as p_tr
from repro_torch.core import types as p_types
from repro_torch.data import synthetic as p_syn

HWS = ("MSP430", "STM32H747", "TPU_V5E")


def _costs(module, depth, seed=0):
    rng = np.random.default_rng(seed)
    return [
        module.BlockCost(
            weight_bytes=float(rng.integers(1, 5000)),
            flops=float(rng.integers(1, 10**6)),
            act_bytes=float(rng.integers(0, 4000)),
        )
        for _ in range(depth)
    ]


def _graphs(n, bp):
    ref = r_tg.enumerate_task_graphs(n, bp)
    port = p_tg.enumerate_task_graphs(n, bp)
    return ref, port


def _port_graph(g):
    return p_tg.TaskGraph(g.num_tasks, g.partitions)


def _stats(s):
    return dataclasses.asdict(s)


# ------------------------------------------------------------------ types

@pytest.mark.parametrize("hw", HWS)
def test_hardware_presets_equal(hw):
    ref, port = getattr(r_types, hw), getattr(p_types, hw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    for bc_r, bc_p in zip(_costs(r_types, 4), _costs(p_types, 4)):
        assert bc_r.total_seconds(ref) == bc_p.total_seconds(port)
        assert bc_r.energy_joules(ref) == bc_p.energy_joules(port)


def test_execution_stats_arithmetic_equal():
    rng = np.random.default_rng(3)
    fields = [f.name for f in dataclasses.fields(r_types.ExecutionStats)]
    assert fields == [f.name for f in dataclasses.fields(p_types.ExecutionStats)]
    vals = [{f: float(rng.integers(0, 1000)) for f in fields} for _ in range(2)]
    r = r_types.ExecutionStats(**vals[0]).merge(r_types.ExecutionStats(**vals[1]))
    p = p_types.ExecutionStats(**vals[0]).merge(p_types.ExecutionStats(**vals[1]))
    assert _stats(r) == _stats(p)
    assert r.seconds(r_types.MSP430) == p.seconds(p_types.MSP430)
    assert r.energy(r_types.MSP430) == p.energy(p_types.MSP430)


# ------------------------------------------------------------ constraints

@pytest.mark.parametrize("seed", range(4))
def test_constraints_equal(seed):
    rng = np.random.default_rng(seed)
    n = 6
    perm = rng.permutation(n)
    prec = [(int(perm[i]), int(perm[j])) for i, j in itertools.combinations(range(n), 2)
            if rng.random() < 0.2]
    cond = [(int(perm[0]), int(perm[n - 1]), 0.25)]
    rc = r_cons.Constraints.make(n, prec, cond)
    pc = p_cons.Constraints.make(n, prec, cond)
    assert rc.precedence == pc.precedence and rc.conditional == pc.conditional
    for order in itertools.islice(itertools.permutations(range(n)), 0, 720, 37):
        assert rc.is_valid_order(order) == pc.is_valid_order(order)
    assert [rc.execution_probability(t) for t in range(n)] == [
        pc.execution_probability(t) for t in range(n)
    ]
    with pytest.raises(ValueError):
        p_cons.Constraints.make(3, [(0, 1), (1, 2), (2, 0)])


# ------------------------------------------------------------- task graphs

@pytest.mark.parametrize("n,bp", [(3, 2), (4, 2), (4, 3), (5, 3)])
def test_enumerate_task_graphs_equal(n, bp):
    ref, port = _graphs(n, bp)
    assert [g.partitions for g in ref] == [g.partitions for g in port]
    rng = np.random.default_rng(n * 10 + bp)
    aff = rng.uniform(-1, 1, size=(bp, n, n))
    for gr, gp in zip(ref, port):
        assert r_tg.variety_score(gr, aff) == p_tg.variety_score(gp, aff)
        assert gr.branch_nodes() == gp.branch_nodes()
        assert [gr.shared_prefix_depth(i, j) for i in range(n) for j in range(n)] == [
            gp.shared_prefix_depth(i, j) for i in range(n) for j in range(n)
        ]


def test_beam_enumeration_equal():
    rng = np.random.default_rng(7)
    aff = rng.uniform(-1, 1, size=(2, 6, 6))
    ref = r_tg.enumerate_task_graphs(
        6, 2, beam=40, variety_fn=lambda g: r_tg.variety_score(g, aff))
    port = p_tg.enumerate_task_graphs(
        6, 2, beam=40, variety_fn=lambda g: p_tg.variety_score(g, aff))
    assert [g.partitions for g in ref] == [g.partitions for g in port]


# -------------------------------------------------------------- cost model

@pytest.mark.parametrize("hw,metric", [(None, "time"), ("MSP430", "time"),
                                        ("MSP430", "energy"), ("TPU_V5E", "time")])
def test_cost_matrix_equal(hw, metric):
    ref_graphs, port_graphs = _graphs(4, 3)
    for gr, gp in zip(ref_graphs, port_graphs):
        cr = r_cm.GraphCostModel(gr, _costs(r_types, 4), hw and getattr(r_types, hw), metric)
        cp = p_cm.GraphCostModel(gp, _costs(p_types, 4), hw and getattr(p_types, hw), metric)
        np.testing.assert_array_equal(cr.cost_matrix(), cp.cost_matrix())
        assert cr.storage_bytes() == cp.storage_bytes()
        assert cr.order_cost([3, 1, 0, 2], cyclic=True) == cp.order_cost([3, 1, 0, 2], cyclic=True)


@dataclasses.dataclass(frozen=True)
class _Probs:
    """A gate model with fixed task and block fire probabilities."""

    task: tuple
    block: float

    def task_probability(self, t):
        return self.task[t]

    def fire_probability(self, t, d):
        return self.block if d % 2 else 1.0


def test_expected_cost_matrix_equal():
    gm = _Probs(task=(1.0, 0.5, 0.25, 0.8), block=0.6)
    for gr, gp in zip(*_graphs(4, 2)):
        cr = r_cm.GraphCostModel(gr, _costs(r_types, 3), r_types.MSP430, gate_model=gm)
        cp = p_cm.GraphCostModel(gp, _costs(p_types, 3), p_types.MSP430, gate_model=gm)
        np.testing.assert_array_equal(cr.expected_cost_matrix(), cp.expected_cost_matrix())
        res = (gr.path(2)[0], None, gr.path(1)[2])
        assert cr.expected_resume_load_cost(res, 3) == cp.expected_resume_load_cost(res, 3)


def _random_trace(module, order, batch, rng, graph):
    """A realized gate trace (weights, whole-group skips, resume depths)."""
    recs, prev = [], None
    for t in order:
        w = int(rng.integers(0, batch + 1))
        if w == 0:
            recs.append(module.TaskGateRecord(task=t, weight=0, offered=batch))
            continue
        resume = 0 if prev is None else graph.shared_prefix_depth(prev, t)
        recs.append(module.TaskGateRecord(task=t, weight=w, resume=resume, offered=batch))
        prev = t
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_predicted_stats_equal_warm_and_gated(seed):
    rng = np.random.default_rng(seed)
    ref_graphs, port_graphs = _graphs(4, 2)
    k = int(rng.integers(len(ref_graphs)))
    gr, gp = ref_graphs[k], port_graphs[k]
    cr = r_cm.GraphCostModel(gr, _costs(r_types, 3, seed), r_types.MSP430)
    cp = p_cm.GraphCostModel(gp, _costs(p_types, 3, seed), p_types.MSP430)
    order = [int(t) for t in rng.permutation(4)]
    batch = int(rng.integers(1, 9))
    warm = tuple(gr.path(int(rng.integers(4))))
    for resume in (None, warm):
        assert _stats(cr.predicted_stats(order, batch, resume=resume)) == _stats(
            cp.predicted_stats(order, batch, resume=resume))
        assert cr.residency_after(order, resume) == cp.residency_after(order, resume)
        assert cr.resume_load_cost(warm, order[0]) == cp.resume_load_cost(warm, order[0])
    trace_r = _random_trace(r_types, order, batch, np.random.default_rng(seed), gr)
    trace_p = _random_trace(p_types, order, batch, np.random.default_rng(seed), gp)
    assert _stats(cr.predicted_stats(order, batch, resume=warm, gate_trace=trace_r)) == _stats(
        cp.predicted_stats(order, batch, resume=warm, gate_trace=trace_p))
    plan = [(order[:2], 3), (order[1:], 5), (order[::-1], 1)]
    assert _stats(cr.predicted_group_stats(plan, resume=warm)) == _stats(
        cp.predicted_group_stats(plan, resume=warm))
    pr = cr.plan_predictor(carry_residency=False)
    pp = cp.plan_predictor(carry_residency=False)
    for o, b in plan:
        assert _stats(pr.append(o, b, extra_tasks_skipped=2)) == _stats(
            pp.append(o, b, extra_tasks_skipped=2))
    assert pr.residency == pp.residency


def test_gate_trace_divergence_raises():
    g = p_tg.TaskGraph.fully_shared(3, 1)
    cm = p_cm.GraphCostModel(g, _costs(p_types, 2), p_types.MSP430)
    bad = [p_types.TaskGateRecord(task=0, weight=1, resume=1)]
    with pytest.raises(ValueError):
        cm.predicted_stats([0], 1, gate_trace=bad)


# ---------------------------------------------------------------- ordering

def _random_matrix(rng, n, symmetric):
    c = rng.uniform(0, 10, size=(n, n))
    if symmetric:
        c = (c + c.T) / 2
    np.fill_diagonal(c, 0)
    return c


@pytest.mark.parametrize("solver", ["brute_force", "held_karp", "branch_and_bound",
                                    "greedy_2opt", "auto"])
@pytest.mark.parametrize("seed", range(3))
def test_optimal_order_equal(solver, seed):
    rng = np.random.default_rng(seed)
    n = 6
    c = _random_matrix(rng, n, symmetric=bool(seed % 2))
    prec = [(0, 3), (2, 5)] if seed else []
    cond = [(1, 4, 0.5)] if seed == 2 else []
    r = r_ord.optimal_order(c, r_cons.Constraints.make(n, prec, cond), solver=solver)
    p = p_ord.optimal_order(c, p_cons.Constraints.make(n, prec, cond), solver=solver)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert r_ord.fitness(r.order, c) == p_ord.fitness(p.order, c)


@pytest.mark.parametrize("seed", range(3))
def test_solve_suborder_and_ilp_equal(seed):
    rng = np.random.default_rng(seed)
    c = _random_matrix(rng, 7, symmetric=False)
    tasks = [5, 1, 3, 6]
    start = list(rng.uniform(0, 3, size=4))
    cons_r = r_cons.Constraints.make(7, [(1, 6)])
    cons_p = p_cons.Constraints.make(7, [(1, 6)])
    assert r_ord.solve_suborder(c, tasks, start, cons_r) == p_ord.solve_suborder(
        c, tasks, start, cons_p)
    assert r_ord.solve_suborder(c, tasks, exact_limit=2) == p_ord.solve_suborder(
        c, tasks, exact_limit=2)
    ilp_r, ilp_p = r_ord.ILPFormulation(c), p_ord.ILPFormulation(c)
    np.testing.assert_array_equal(ilp_r.objective(), ilp_p.objective())
    np.testing.assert_array_equal(ilp_r.subtour_constraint([0, 2])[0],
                                  ilp_p.subtour_constraint([0, 2])[0])


@pytest.mark.parametrize("crossover", ["ox", "paper"])
@pytest.mark.parametrize("seed", range(2))
def test_genetic_order_equal(crossover, seed):
    rng = np.random.default_rng(10 + seed)
    c = _random_matrix(rng, 8, symmetric=True)
    cfg = dict(seed=seed, crossover=crossover, population=32, elite_pairs=8,
               max_rounds=60, patience=10)
    r = r_ga.genetic_order(c, r_cons.Constraints.make(8, [(2, 7)]), r_ga.GAConfig(**cfg))
    p = p_ga.genetic_order(c, p_cons.Constraints.make(8, [(2, 7)]), p_ga.GAConfig(**cfg))
    assert dataclasses.asdict(r) == dataclasses.asdict(p)


# ---------------------------------------------------------------- tradeoff

@pytest.mark.parametrize("n", [4, 5])
def test_select_task_graph_equal(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(-1, 1, size=(3, n, n))
    aff = (a + a.transpose(0, 2, 1)) / 2
    r = r_tr.select_task_graph(n, 3, aff, _costs(r_types, 4), r_types.MSP430)
    p = p_tr.select_task_graph(n, 3, aff, _costs(p_types, 4), p_types.MSP430)
    assert r.selected.graph.partitions == p.selected.graph.partitions
    assert (r.selected.variety, r.selected.exec_cost, r.selected.order) == (
        p.selected.variety, p.selected.exec_cost, p.selected.order)
    np.testing.assert_array_equal(r.budgets, p.budgets)
    np.testing.assert_array_equal(r.variety_trend, p.variety_trend)
    np.testing.assert_array_equal(r.cost_trend, p.cost_trend)
    assert r.selected_budget == p.selected_budget


# ---------------------------------------------------------------- dataset

def test_multitask_dataset_bit_equal():
    r = r_syn.MultitaskDataset(num_tasks=5, num_classes=4, seed=3)
    p = p_syn.MultitaskDataset(num_tasks=5, num_classes=4, seed=3)
    (rx, ry), (rxt, ryt) = r_syn.train_test_split(r, 32, 16)
    (px, py), (pxt, pyt) = p_syn.train_test_split(p, 32, 16)
    for a, b in ((rx, px), (ry, py), (rxt, pxt), (ryt, pyt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
