"""The port's serving session, scheduling policies and per-plan re-solving,
re-pointed from ``tests/test_session.py``, and held against the JAX
package's session on the same traces.

The contract under test: admission timing, scheduling policy and per-plan
re-solving change *what gets batched together, in what order, and what gets
loaded* — never *what gets computed* — and the session's cumulative executed
counters equal its incremental prediction field for field.  Against the
reference: the same programs (the reference's weights carried over), the
same arrival trace on a simulated clock and the same scripted fault
schedule give the same admission rounds (seq lists), the same group
attempts (tasks, valid rows, effective order, dispatch mode), the same
per-response ``retries`` and ``degraded``, and ``session.stats`` equal to
the reference's field for field, under each of the four policies; outputs
agree to fp32 1e-5 on LeNet-5 and on a 2-layer smoke transformer.

Hypothesis runs derandomized (``derandomize=True, database=None``), so the
examples are the same on every run.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as r_configs
from repro.core import task_graph as r_tg
from repro.core.types import MSP430 as R_MSP430, TPU_V5E as R_TPU
from repro.models import multitask as r_mt
from repro.serving import engine as r_engine
from repro.serving import policies as r_pol
from repro.serving import reliability as r_rel
from repro.serving.batching import RequestGroupScheduler as RScheduler
from repro_torch import configs as p_configs
from repro_torch.core import (
    BlockCost, Constraints, GraphCostModel, MSP430, MultitaskProgram,
    TPU_V5E, solve_suborder,
)
from repro_torch.core.cost_model import PlanPredictor
from repro_torch.core.task_graph import TaskGraph
from repro_torch.models import multitask as p_mt
from repro_torch.serving import (
    AffinityPolicy, EnginePolicy, GreedyBatchPolicy, MultitaskEngine,
    MultitaskRequest, RequestError, RequestGroupScheduler, RetryPolicy,
    SloAwarePolicy, WindowPolicy,
)
from repro_torch.serving import engine as p_engine
from repro_torch.serving import policies as p_pol
from repro_torch.serving import reliability as p_rel

DIM = 8
GRAPH = TaskGraph.from_groups([
    [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]],
])
GRAPH6 = TaskGraph.from_groups([
    [[0, 1, 2, 3, 4, 5]],
    [[0, 1, 2], [3, 4, 5]],
    [[0, 1], [2], [3], [4, 5]],
    [[0], [1], [2], [3], [4], [5]],
])
SUBSET_CHOICES = (None, (0,), (1, 2), (0, 3), (2, 1), (0, 1, 2, 3))
TOL = dict(rtol=1e-5, atol=1e-6)
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)


def _block(p, x):
    return torch.tanh(x @ p)


def _head(p, x):
    return x @ p


def _program(graph=GRAPH, seed=0, uniform_costs=False):
    """The reference tests' toy program (``tanh(x @ W)`` blocks, linear
    heads), its weights drawn by ``np.random.default_rng(seed)`` in the
    reference's order."""
    rng = np.random.default_rng(seed)
    costs = [
        BlockCost(weight_bytes=10.0, flops=1.0) if uniform_costs
        else BlockCost(weight_bytes=100.0 * (d + 1), flops=10.0 * (d + 1))
        for d in range(graph.depth)
    ]
    node_params = {
        node: torch.tensor(rng.normal(size=(DIM, DIM)), dtype=torch.float32)
        for node in graph.nodes()
    }
    head_params = [torch.tensor(rng.normal(size=(DIM, 3)), dtype=torch.float32)
                   for _ in range(graph.num_tasks)]
    return MultitaskProgram(
        graph, [_block] * graph.depth, node_params, [_head] * graph.num_tasks,
        head_params, costs,
    )


PROGRAM = _program()


class FakeClock:
    """Deterministic session clock for admission-window tests."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t

    def __call__(self) -> float:
        return self.t


def _x(rng):
    return torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32)


def _requests(rng, subsets):
    return [MultitaskRequest(x=_x(rng), tasks=s) for s in subsets]


def _assert_outputs_close(got, ref, tol=TOL):
    assert set(got.outputs) == set(ref.outputs)
    for t in got.outputs:
        np.testing.assert_allclose(
            got.outputs[t].numpy(), ref.outputs[t].numpy(), **tol)


# --------------------------------------------------------------------------
# One-shot parity: sessions reproduce serve_batch exactly
# --------------------------------------------------------------------------

def test_greedy_session_reproduces_serve_batch_exactly():
    rng = np.random.default_rng(0)
    subsets = [None, (0,), (1, 2), (0, 3), (2, 1), None, (1, 2)]
    reqs = _requests(rng, subsets)
    sched = lambda: RequestGroupScheduler(batch_shapes=(1, 4))  # noqa: E731
    ref = MultitaskEngine(PROGRAM, hw=MSP430, scheduler=sched())
    eng = MultitaskEngine(PROGRAM, hw=MSP430, scheduler=sched())
    ref_resp = ref.serve_batch(reqs)

    session = eng.session()  # defaults to GreedyBatchPolicy
    futures = [session.submit(r) for r in reqs]
    assert not any(f.done() for f in futures)  # nothing runs before a pump
    session.drain()
    assert all(f.done() for f in futures)
    assert session.stats == ref.last_batch_stats
    assert session.stats == session.predicted == session.expected
    assert session.admission_rounds == 1       # greedy = one planning batch
    assert session.requests_admitted == len(reqs)
    for f, rr in zip(futures, ref_resp):
        rs = f.result()
        assert rs.group_size == rr.group_size
        assert rs.effective_order == tuple(
            t for t in eng.order if t in rs.outputs)
        assert rs.stats == rr.stats
        assert (rs.retries, rs.degraded) == (0, None)
        _assert_outputs_close(rs, rr)


def test_response_effective_order_reports_group_suborder():
    rng = np.random.default_rng(1)
    eng = MultitaskEngine(PROGRAM, hw=MSP430)
    resp = eng.serve(MultitaskRequest(x=_x(rng), tasks=(1, 2)))
    assert resp.order == eng.order
    assert resp.effective_order == tuple(t for t in eng.order if t in (1, 2))
    assert set(resp.effective_order) == set(resp.outputs)
    assert resp.stats.tasks_run == 2
    assert resp.stats.tasks_skipped == 2


def test_future_result_drives_drain():
    rng = np.random.default_rng(2)
    eng = MultitaskEngine(PROGRAM, hw=MSP430)
    session = eng.session()
    fut = session.submit(MultitaskRequest(x=_x(rng)))
    assert not fut.done()
    resp = fut.result()  # drains the session on demand
    assert fut.done() and set(resp.outputs) == {0, 1, 2, 3}
    assert session.pending_count() == 0


def test_serve_many_deprecated_but_equivalent():
    rng = np.random.default_rng(3)
    reqs = _requests(rng, [None, (1, 2)])
    eng = MultitaskEngine(PROGRAM, hw=MSP430)
    ref = MultitaskEngine(PROGRAM, hw=MSP430)
    ref_resp = ref.serve_batch(reqs)
    with pytest.warns(DeprecationWarning, match="serve_many is deprecated"):
        resp = eng.serve_many(reqs)
    for rm, rr in zip(resp, ref_resp):
        _assert_outputs_close(rm, rr)


def test_pump_failure_isolated_to_failing_group():
    def bad_gate(outputs):
        raise ValueError("gate exploded")

    rng = np.random.default_rng(14)
    eng = MultitaskEngine(PROGRAM, hw=MSP430, gates={1: bad_gate},
                          order=[0, 1, 2, 3])
    session = eng.session(retry=RetryPolicy(max_retries=0, degrade=False))
    f_ok = session.submit(MultitaskRequest(x=_x(rng), tasks=(0,)))
    f_bad = session.submit(MultitaskRequest(x=_x(rng)))
    session.drain()  # must not raise: the failure rides the futures
    assert f_ok.done() and f_bad.done()
    assert f_ok.error() is None and f_ok.result().outputs.keys() == {0}
    with pytest.raises(RequestError, match="gate exploded") as exc:
        f_bad.result()
    assert isinstance(exc.value.__cause__, ValueError)
    assert exc.value.seq == f_bad.seq
    assert exc.value.group_id is not None
    assert session.groups_failed == 1 and session.requests_failed == 1


def test_drain_raises_on_noncompliant_policy():
    class StubbornPolicy:
        """Violates the flush contract: never admits anything."""

        def admit(self, queue, engine, now, flush):
            return []

    rng = np.random.default_rng(15)
    session = MultitaskEngine(PROGRAM, hw=MSP430).session(policy=StubbornPolicy())
    session.submit(MultitaskRequest(x=_x(rng)))
    with pytest.raises(RuntimeError, match="drain incomplete"):
        session.drain()


# --------------------------------------------------------------------------
# EnginePolicy config object
# --------------------------------------------------------------------------

def test_engine_policy_folds_legacy_flags():
    eng = MultitaskEngine(PROGRAM, hw=MSP430, warm_start=False,
                          group_ordering=False)
    assert eng.policy == EnginePolicy(
        warm_start=False, group_ordering=False,
        scheduling=eng.policy.scheduling, scheduler=eng.policy.scheduler)
    assert not eng.warm_start and not eng.group_ordering
    assert isinstance(eng.policy.scheduling, GreedyBatchPolicy)
    assert isinstance(eng.policy.scheduler, RequestGroupScheduler)
    assert eng.scheduler is eng.policy.scheduler

    sched = RequestGroupScheduler(batch_shapes=(1, 2))
    pol = EnginePolicy(warm_start=False, scheduling=WindowPolicy(max_wait=1.0))
    eng = MultitaskEngine(PROGRAM, hw=MSP430, policy=pol, scheduler=sched)
    assert not eng.warm_start and eng.group_ordering
    assert eng.scheduler is sched and eng.policy.scheduler is sched
    assert isinstance(eng.policy.scheduling, WindowPolicy)
    eng = MultitaskEngine(PROGRAM, hw=MSP430, policy=pol, warm_start=True)
    assert eng.warm_start


def test_policy_validation():
    with pytest.raises(ValueError):
        WindowPolicy(max_group_size=0)
    with pytest.raises(ValueError):
        WindowPolicy(max_wait=-1.0)
    with pytest.raises(ValueError):
        AffinityPolicy(max_group_size=0)
    with pytest.raises(ValueError):
        SloAwarePolicy(max_group_size=0)
    with pytest.raises(ValueError):
        SloAwarePolicy(slack_threshold=-1.0)
    with pytest.raises(ValueError):
        SloAwarePolicy(starvation_wait=-1.0)


# --------------------------------------------------------------------------
# WindowPolicy and AffinityPolicy
# --------------------------------------------------------------------------

def test_window_policy_admits_by_size_and_age():
    rng = np.random.default_rng(4)
    clock = FakeClock()
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430,
        policy=EnginePolicy(
            scheduling=WindowPolicy(max_wait=1.0, max_group_size=3)),
        scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)),
    )
    session = eng.session(clock=clock)
    f1 = session.submit(MultitaskRequest(x=_x(rng)))
    f2 = session.submit(MultitaskRequest(x=_x(rng)))
    assert session.step() == []  # below both thresholds: the window holds
    assert not f1.done() and session.pending_count() == 2
    f3 = session.submit(MultitaskRequest(x=_x(rng)))
    done = session.step()
    assert len(done) == 3 and all(f.done() for f in (f1, f2, f3))
    f4 = session.submit(MultitaskRequest(x=_x(rng)))
    assert session.step() == [] and not f4.done()
    clock.advance(1.5)
    assert len(session.step()) == 1 and f4.done()
    assert len(session.waits) == 4
    assert session.waits[-1] == pytest.approx(1.5)


def test_window_policy_respects_group_size_cap():
    rng = np.random.default_rng(5)
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430,
        policy=EnginePolicy(
            scheduling=WindowPolicy(max_wait=10.0, max_group_size=2)),
        scheduler=RequestGroupScheduler(batch_shapes=(1, 2)),
    )
    session = eng.session(clock=FakeClock())
    for _ in range(5):
        session.submit(MultitaskRequest(x=_x(rng)))
    session.drain()
    assert session.admission_rounds == 3
    assert session.requests_admitted == 5


def test_affinity_policy_picks_residency_nearest_bucket():
    prog = _program(GRAPH6, seed=6)
    rng = np.random.default_rng(6)
    eng = MultitaskEngine(
        prog, hw=MSP430,
        policy=EnginePolicy(
            scheduling=AffinityPolicy(max_group_size=2), group_ordering=False),
        scheduler=RequestGroupScheduler(batch_shapes=(1, 2)),
    )
    eng.serve(MultitaskRequest(x=_x(rng), tasks=(0, 1)))
    session = eng.session()
    _far = session.submit(MultitaskRequest(x=_x(rng), tasks=(3, 4)))
    near = session.submit(MultitaskRequest(x=_x(rng), tasks=(0, 1)))
    completed = session.flush()
    assert len(completed) == 2
    assert near.result().effective_order[0] in (0, 1)
    assert session.admission_rounds == 2
    assert set(completed[0].outputs) == {0, 1}
    assert completed[0].stats.weight_bytes_skipped > 0


def test_affinity_policy_min_pending_zero_admits_immediately():
    rng = np.random.default_rng(13)
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430,
        policy=EnginePolicy(scheduling=AffinityPolicy(
            max_group_size=4, min_pending=0)),
    )
    session = eng.session(clock=FakeClock())
    f = session.submit(MultitaskRequest(x=_x(rng)))
    assert len(session.step()) == 1 and f.done()


def test_affinity_policy_waits_below_threshold():
    rng = np.random.default_rng(7)
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430,
        policy=EnginePolicy(scheduling=AffinityPolicy(
            max_group_size=4, min_pending=3, max_wait=5.0)),
    )
    clock = FakeClock()
    session = eng.session(clock=clock)
    f = session.submit(MultitaskRequest(x=_x(rng)))
    assert session.step() == []
    clock.advance(6.0)
    assert len(session.step()) == 1
    assert f.done()


# --------------------------------------------------------------------------
# Per-plan order re-solving and incremental prediction
# --------------------------------------------------------------------------

def test_solve_suborder_restricts_and_seeds():
    cm = GraphCostModel(GRAPH6, _program(GRAPH6).block_costs, MSP430)
    cost = cm.cost_matrix()
    assert solve_suborder(cost, []) == []
    assert solve_suborder(cost, [3]) == [3]
    sub = solve_suborder(cost, [0, 3, 1, 4])
    assert sorted(sub) == [0, 1, 3, 4]
    resident = tuple(GRAPH6.path(4))
    starts = [cm.resume_load_cost(resident, t) for t in (0, 3, 1, 4)]
    sub = solve_suborder(cost, [0, 3, 1, 4], start_costs=starts)
    assert sub[0] in (3, 4) and sorted(sub) == [0, 1, 3, 4]
    cons = Constraints.make(6, precedence=[(1, 0), (5, 2)])
    sub = solve_suborder(cost, [0, 3, 1, 4], start_costs=starts,
                         constraints=cons)
    assert sub.index(1) < sub.index(0)
    with pytest.raises(ValueError):
        solve_suborder(cost, [0, 1], start_costs=[1.0])


def test_resolve_order_per_plan_reduces_loads_not_outputs():
    prog = _program(GRAPH6, seed=8)
    rng = np.random.default_rng(8)
    reqs = _requests(rng, [(2, 3), (0, 5), (1, 4), None, (2, 5)])

    def engine(resolve):
        return MultitaskEngine(
            prog, hw=MSP430,
            policy=EnginePolicy(resolve_order_per_plan=resolve),
            scheduler=RequestGroupScheduler(batch_shapes=(1,)),
        )

    base, resolved = engine(False), engine(True)
    for _round in range(2):  # second round runs warm from the first
        pred = resolved.predicted_group_stats(resolved.plan_groups(reqs))
        r_resp = resolved.serve_batch(reqs)
        b_resp = base.serve_batch(reqs)
        assert resolved.last_batch_stats == pred
        assert (resolved.last_batch_stats.weight_bytes_loaded
                <= base.last_batch_stats.weight_bytes_loaded)
        assert (resolved.last_batch_stats.tasks_run
                == base.last_batch_stats.tasks_run)
        for rr, rb in zip(r_resp, b_resp):
            assert sorted(rr.effective_order) == sorted(rb.effective_order)
            _assert_outputs_close(rr, rb)
    assert (resolved.last_batch_stats.weight_bytes_loaded
            < base.last_batch_stats.weight_bytes_loaded)


def test_resolve_order_respects_precedence_constraints():
    cons = Constraints.make(4, precedence=[(3, 1)])
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430, constraints=cons,
        policy=EnginePolicy(resolve_order_per_plan=True),
        scheduler=RequestGroupScheduler(batch_shapes=(1,)),
    )
    rng = np.random.default_rng(9)
    for subset in [(1, 3), (0, 1, 3), None]:
        eff = eng.serve(MultitaskRequest(x=_x(rng), tasks=subset)).effective_order
        assert eff.index(3) < eff.index(1)


def test_resolve_order_disabled_with_gates():
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430, gates={1: lambda outputs: bool(outputs[0][0] > 0)},
        order=[0, 1, 2, 3], policy=EnginePolicy(resolve_order_per_plan=True),
    )
    groups = eng.plan_groups(_requests(np.random.default_rng(10), [None, (0, 1)]))
    assert all(g.order is None for g in groups)  # gate order preserved


def test_resolve_order_with_conditional_constraints_uses_expected_costs():
    cons = Constraints.make(4, conditional=[(0, 1, 0.5)])
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430, constraints=cons,
        policy=EnginePolicy(resolve_order_per_plan=True),
    )
    rng = np.random.default_rng(16)
    groups = eng.plan_groups(_requests(rng, [None, (0, 1)]))
    assert any(g.order is not None for g in groups)
    for g in groups:
        if g.order is not None:
            pos = {t: k for k, t in enumerate(g.order)}
            assert all(pos[i] < pos[j] for (i, j) in cons.precedence
                       if i in pos and j in pos)
    mat = eng._resolve_matrix()
    exact = eng.cost_model.cost_matrix()
    for i in range(4):
        if i == 1:
            continue
        assert mat[i, 1] == pytest.approx(0.5 * exact[i, 1])
        assert mat[1, i] == pytest.approx(exact[1, i])
    reqs = _requests(rng, [None, (0, 1), (1, 2, 3)])
    base = MultitaskEngine(PROGRAM, hw=MSP430, constraints=cons)
    s1 = eng.session()
    f1 = [s1.submit(r) for r in reqs]
    s1.drain()
    assert s1.stats == s1.predicted
    for fa, rb in zip(f1, base.serve_batch(reqs)):
        _assert_outputs_close(fa.result(), rb)


def test_plan_predictor_matches_one_shot_prediction():
    prog = _program(GRAPH6, seed=11)
    cm = GraphCostModel(GRAPH6, prog.block_costs, MSP430)
    rng = np.random.default_rng(11)
    plan = [(list(rng.permutation(6)), int(rng.integers(1, 5))) for _ in range(4)]
    resume = tuple(GRAPH6.path(2))
    one_shot = cm.predicted_group_stats(plan, resume=resume)
    inc = cm.plan_predictor(resume=resume)
    deltas = [inc.append(order, b) for order, b in plan]
    assert inc.stats == one_shot
    assert inc.groups == len(plan)
    merged = deltas[0]
    for d in deltas[1:]:
        merged = merged.merge(d)
    assert merged == one_shot
    assert inc.residency == tuple(GRAPH6.path(plan[-1][0][-1]))
    cold = cm.plan_predictor(carry_residency=False)
    for order, b in plan:
        cold.append(order, b)
    per_group = None
    for order, b in plan:
        s = cm.predicted_stats(order, batch_size=b)
        per_group = s if per_group is None else per_group.merge(s)
    assert cold.stats == per_group
    with pytest.raises(ValueError):
        PlanPredictor(cm, resume=(None,))


# --------------------------------------------------------------------------
# Property: sessioned serving == sequential serve(), counters exact
# --------------------------------------------------------------------------

POLICY_MAKERS = (
    lambda: GreedyBatchPolicy(),
    lambda: WindowPolicy(max_wait=0.5, max_group_size=3),
    lambda: AffinityPolicy(max_group_size=4, min_pending=2, max_wait=2.0),
    lambda: SloAwarePolicy(max_group_size=3, min_pending=2, max_wait=1.0,
                           starvation_wait=1.5),
)


def check_session_matches_sequential(spec, data_seed, policy_idx, gated, resolve):
    """Any admission order/policy/gating: the outputs of sequential
    ``serve()`` and counters equal to the incremental prediction."""
    rng = np.random.default_rng(data_seed)
    reqs = _requests(rng, [SUBSET_CHOICES[i] for i, _dt in spec])
    gates = {}
    if gated:
        def gate(outputs):
            if 0 not in outputs:
                return True
            return bool(outputs[0][0] > 0)

        gates = {t: gate for t in range(1, 4)}
    order = [0, 1, 2, 3] if gated else None
    eng = MultitaskEngine(
        PROGRAM, hw=MSP430, gates=gates, order=order,
        policy=EnginePolicy(scheduling=POLICY_MAKERS[policy_idx](),
                            resolve_order_per_plan=resolve),
        scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)),
    )
    solo = MultitaskEngine(
        PROGRAM, hw=MSP430, gates=gates, order=order,
        warm_start=False, group_ordering=False,
        scheduler=RequestGroupScheduler(batch_shapes=(1,)),
    )
    clock = FakeClock()
    session = eng.session(clock=clock)
    futures = []
    for req, (_si, dt) in zip(reqs, spec):
        clock.advance(dt)
        futures.append(session.submit(req))
        session.step()
    session.drain()
    assert all(f.done() for f in futures)
    assert session.requests_admitted == len(reqs)
    assert session.stats == session.predicted == session.expected
    for f, req in zip(futures, reqs):
        rs = f.result()
        assert set(rs.effective_order) >= set(rs.outputs)
        _assert_outputs_close(rs, solo.serve(req))


def test_session_matches_sequential_fixed_seeds():
    rng = np.random.default_rng(12)
    for trial in range(8):
        n = int(rng.integers(1, 9))
        spec = [(int(rng.integers(0, len(SUBSET_CHOICES))),
                 float(rng.uniform(0.0, 1.0))) for _ in range(n)]
        check_session_matches_sequential(
            spec, data_seed=trial, policy_idx=trial % len(POLICY_MAKERS),
            gated=bool(trial % 2), resolve=bool((trial // 2) % 2),
        )


@settings(max_examples=15, deadline=None, derandomize=True, database=None)
@given(
    spec=st.lists(
        st.tuples(st.integers(0, len(SUBSET_CHOICES) - 1),
                  st.floats(0.0, 2.0, allow_nan=False)),
        min_size=1, max_size=8,
    ),
    data_seed=st.integers(0, 2**16),
    policy_idx=st.integers(0, len(POLICY_MAKERS) - 1),
    gated=st.booleans(),
    resolve=st.booleans(),
)
def test_session_matches_sequential_hypothesis(spec, data_seed, policy_idx, gated, resolve):
    check_session_matches_sequential(spec, data_seed, policy_idx, gated, resolve)


# --------------------------------------------------------------------------
# Held against the reference session: same trace, same faults
# --------------------------------------------------------------------------

LENET_GRAPH = r_tg.TaskGraph.from_groups([
    [[0, 1, 2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0], [1], [2], [3], [4]],
])
TF_GRAPH = r_tg.TaskGraph.from_groups([[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]]])
TF_SEQ = 12
PARITY_POLICIES = {
    "greedy": lambda pol: pol.GreedyBatchPolicy(),
    "window": lambda pol: pol.WindowPolicy(max_wait=0.3, max_group_size=3),
    "affinity": lambda pol: pol.AffinityPolicy(max_group_size=3, min_pending=2, max_wait=0.5),
    "slo": lambda pol: pol.SloAwarePolicy(max_group_size=3, min_pending=3, max_wait=0.6,
                                          slack_threshold=0.1, starvation_wait=0.4),
}
# Invocation indices that always fault: with max_retries=1, two consecutive
# "plan" faults send one group to the unfused rung; the lone "load" and
# "dispatch" faults are retried on the primary path (or, where one lands on
# a retry, send that group to the rung too).
FAULT_SCRIPT = {"plan": {1, 2}, "load": {5}, "dispatch": {16}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lenet_programs():
    """Both packages' LeNet-5 programs, the hardware model each is planned
    with, and a maker of one request input."""
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(0), LENET_GRAPH, [4, 3, 4, 2, 4])
    port = p_mt.program_from_reference(
        TaskGraph(LENET_GRAPH.num_tasks, LENET_GRAPH.partitions),
        _np_tree(ref.node_params), _np_tree(ref.head_params), device="cpu",
    )
    return ref, port, R_MSP430, MSP430, lambda rng: rng.standard_normal(
        (1, 28, 28, 1)).astype(np.float32)


def _transformer_programs():
    rcfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"), num_layers=2)
    pcfg = dataclasses.replace(p_configs.get_smoke_config("mistral-nemo-12b"), num_layers=2)
    graph = TF_GRAPH
    ref = r_mt.build_transformer_program(jax.random.PRNGKey(0), graph, rcfg, [4, 3, 5], TF_SEQ)
    port = p_mt.transformer_program_from_reference(
        TaskGraph(graph.num_tasks, graph.partitions), pcfg,
        _np_tree(ref.node_params), _np_tree(ref.head_params), TF_SEQ, device="cpu",
    )
    return ref, port, R_TPU, TPU_V5E, lambda rng: rng.integers(
        0, 1000, (1, TF_SEQ)).astype(np.int32)


class Recorder:
    """Wraps a policy and an engine's group execution: the seq lists of the
    admission rounds, and each execution attempt's (tasks, valid rows,
    effective order, fused)."""

    def __init__(self, policy, engine):
        self.policy, self.engine = policy, engine
        self.rounds, self.attempts = [], []
        execute = engine._execute_group

        def recorded(group, *args, **kwargs):
            self.attempts.append((
                None if group.tasks is None else sorted(group.tasks), group.valid,
                tuple(engine.group_order(group)), engine.executor.fused,
            ))
            return execute(group, *args, **kwargs)

        engine._execute_group = recorded

    def admit(self, queue, engine, now, flush):
        admitted = self.policy.admit(queue, engine, now, flush)
        if admitted:
            self.rounds.append([p.seq for p in admitted])
        return admitted


def _engines(program):
    """The reference's and the port's engines on one program (the
    reference's weights carried over)."""
    ref_prog, port_prog, r_hw, p_hw, make_x = (
        _lenet_programs() if program == "lenet" else _transformer_programs())
    return (
        r_engine.MultitaskEngine(ref_prog, hw=r_hw, scheduler=RScheduler(batch_shapes=(1, 2, 4))),
        p_engine.MultitaskEngine(port_prog, hw=p_hw,
                                 scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4))),
        make_x,
    )


@pytest.fixture(scope="module")
def parity_engines():
    """Engines built once per program for the module: the reference's
    compiled suffixes are kept across the policy cases, and each case
    starts from a cold executor."""
    cache = {}

    def get(program):
        if program not in cache:
            cache[program] = _engines(program)
        return cache[program]

    return get


def _serve_trace(engine, pol, rel, request_cls, trace, policy):
    """Serve ``trace`` ((dt, x, tasks, deadline, priority, tenant) rows)
    through a session of ``engine``, cold, on a simulated clock, under the
    scripted faults."""
    engine.executor.reset()
    engine.fault_injector = rel.FaultInjector(script=FAULT_SCRIPT)
    rec = Recorder(PARITY_POLICIES[policy](pol), engine)
    try:
        clock = FakeClock()
        session = engine.session(policy=rec, clock=clock, sleep=lambda s: None,
                                 retry=rel.RetryPolicy(max_retries=1))
        futures = []
        for dt, x, tasks, deadline, priority, tenant in trace:
            clock.advance(dt)
            futures.append(session.submit(request_cls(
                x=x, tasks=tasks, deadline=deadline, priority=priority, tenant=tenant)))
            session.step()
        session.drain()
    finally:
        del engine._execute_group  # the recorder's wrapper
    return session, futures, rec


def _trace(make_x, n=10, seed=3):
    rng = np.random.default_rng(seed)
    subsets = (None, (0, 1), (2,), (1, 2), (0,))
    return [(
        float(rng.uniform(0.0, 0.25)), make_x(rng), subsets[int(rng.integers(len(subsets)))],
        None if i % 3 else float(rng.uniform(0.5, 2.0)), int(rng.integers(0, 3)),
        ("a", "b", None)[i % 3],
    ) for i in range(n)]


@pytest.mark.parametrize("policy", list(PARITY_POLICIES))
@pytest.mark.parametrize("program", ["lenet", "transformer"])
def test_session_matches_reference_session(parity_engines, program, policy):
    ref_engine, port_engine, make_x = parity_engines(program)
    trace = _trace(make_x)
    ref, ref_futs, ref_rec = _serve_trace(
        ref_engine, r_pol, r_rel, r_engine.MultitaskRequest, trace, policy)
    port, port_futs, port_rec = _serve_trace(
        port_engine, p_pol, p_rel, p_engine.MultitaskRequest, trace, policy)

    assert port_rec.rounds == ref_rec.rounds
    assert port_rec.attempts == ref_rec.attempts
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.stats == port.predicted
    for name in ("admission_rounds", "groups_executed", "groups_failed", "group_retries",
                 "degraded_runs", "requests_admitted", "requests_expired",
                 "requests_failed", "wait_sum", "wait_max"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.engine.fault_injector.injected == ref.engine.fault_injector.injected
    retried = degraded = 0
    for rf, pf in zip(ref_futs, port_futs):
        assert (rf.error() is None) == (pf.error() is None)
        if rf.error() is not None:
            assert type(pf.error()).__name__ == type(rf.error()).__name__
            continue
        r, p = rf.result(), pf.result()
        assert (p.retries, p.degraded) == (r.retries, r.degraded)
        assert (p.effective_order, p.group_size) == (r.effective_order, r.group_size)
        assert dataclasses.asdict(p.stats) == dataclasses.asdict(r.stats)
        assert set(p.outputs) == set(r.outputs)
        for t in r.outputs:
            np.testing.assert_allclose(
                p.outputs[t].float().numpy(), np.asarray(r.outputs[t], np.float32),
                **PARITY_TOL)
        retried += p.retries > 0 and p.degraded is None
        degraded += p.degraded == "unfused"
    # The script must exercise both recovery paths.
    assert retried >= 1 and degraded >= 1
