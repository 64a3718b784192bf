"""The port's double-buffered weight streaming, re-pointed from
``tests/test_streaming.py`` (all 19 tests) and held against the JAX
package on the same programs and traces.

The contract under test: streaming changes *when* weight bytes move, never
*what* gets computed or *how many* bytes move — outputs stay identical to
synchronous serving, ``weight_bytes_loaded`` is unchanged, and
``session.stats == session.predicted`` stays exact including
``prefetched_bytes`` / ``stream_stall_seconds``.  Against the reference:
the same weights (drawn by one ``np.random.default_rng`` in the
reference's order), the same requests and the same fault scripts give the
same load schedules, the same counters field for field (streaming counters
included), the same session counters (prefetches, failures, retries) and
outputs within fp32 1e-5 relative + 1e-5 absolute of the reference's, the
cross-package tolerance of ``tests/test_torch_session.py`` (its tests hold a streamed run to a synchronous one at 1e-6 relative; the port
holds its own streamed and synchronous runs bit-identical, a stronger
gate, and only the cross-package products differ in their last bits).
On the CPU a stage is a synchronous copy; the side-stream copy is held on
the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GraphCostModel as RCostModel
from repro.core import MSP430 as R_MSP430
from repro.core import MultitaskProgram as RProgram
from repro.core import TaskGraphExecutor as RExecutor
from repro.core.task_graph import TaskGraph as RTaskGraph
from repro.core.types import BlockCost as RBlockCost
from repro.core.types import ExecutionStats as RStats
from repro.serving import EnginePolicy as REnginePolicy
from repro.serving import FaultInjector as RFaultInjector
from repro.serving import MultitaskEngine as REngine
from repro.serving import MultitaskRequest as RRequest
from repro.serving import RequestGroupScheduler as RScheduler
from repro.serving import RetryPolicy as RRetry
from repro_torch.core import (
    BlockCost, GraphCostModel, MSP430, MultitaskProgram, TaskGraphExecutor,
)
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import ExecutionStats
from repro_torch.serving import (
    EnginePolicy, FaultInjector, InjectedFault, MultitaskEngine,
    MultitaskRequest, RequestGroupScheduler, RetryPolicy,
)

DIM = 8
SUBSETS = ((0, 1), (3, 4), (0, 1, 2), (3, 4, 5), (0, 2), (4, 5))
GROUPS = [
    [[0, 1, 2, 3, 4, 5]],
    [[0, 1, 2], [3, 4, 5]],
    [[0, 1], [2], [3, 4], [5]],
    [[0], [1], [2], [3], [4], [5]],
]
OUT_TOL = dict(rtol=1e-5, atol=1e-5)   # port vs reference, fp32
SOLO_TOL = dict(rtol=1e-5, atol=1e-6)  # the reference test's own


def _graphs():
    # Depth-4 split: tasks {0,1,2} and {3,4,5} share nothing past depth 0.
    return TaskGraph.from_groups(GROUPS), RTaskGraph.from_groups(GROUPS)


def _programs(seed=0):
    """The reference tests' program in both packages, one set of weights."""
    graph, rgraph = _graphs()
    rng = np.random.default_rng(seed)
    costs = [(100.0 * (d + 1), 10.0 * (d + 1)) for d in range(graph.depth)]
    nodes = {node: rng.normal(size=(DIM, DIM)).astype(np.float32)
             for node in rgraph.nodes()}
    heads = [rng.normal(size=(DIM, 3)).astype(np.float32)
             for _ in range(graph.num_tasks)]
    port = MultitaskProgram(
        graph, [lambda p, x: torch.tanh(x @ p)] * graph.depth,
        {n: torch.as_tensor(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * graph.num_tasks, [torch.as_tensor(h) for h in heads],
        [BlockCost(weight_bytes=w, flops=f) for w, f in costs],
    )
    ref = RProgram(
        rgraph, [lambda p, x: jnp.tanh(x @ p)] * rgraph.depth,
        {n: jnp.asarray(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * rgraph.num_tasks, [jnp.asarray(h) for h in heads],
        [RBlockCost(weight_bytes=w, flops=f) for w, f in costs],
    )
    return port, ref


PORT, REF = _programs()


def _inputs(seed, n):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _requests(seed, n, subsets=SUBSETS):
    xs = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    port = [MultitaskRequest(x=torch.as_tensor(xs[i]), tasks=subsets[i % len(subsets)])
            for i in range(n)]
    ref = [RRequest(x=jnp.asarray(xs[i]), tasks=subsets[i % len(subsets)])
           for i in range(n)]
    return port, ref


def _same_stats(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _same_outputs(port_out, ref_out, tol=OUT_TOL):
    assert set(port_out) == set(ref_out)
    for t in ref_out:
        np.testing.assert_allclose(port_out[t].numpy(), np.asarray(ref_out[t]), **tol)


def _cost_models():
    return (GraphCostModel(PORT.graph, PORT.block_costs, MSP430),
            RCostModel(REF.graph, REF.block_costs, R_MSP430))


# --------------------------------------------------------------------------
# Cost model: prefetch schedule + stall accounting
# --------------------------------------------------------------------------

def test_plan_loads_matches_predicted_load_bytes():
    cm, rcm = _cost_models()
    graph = PORT.graph
    rng = np.random.default_rng(1)
    resident = (None,) * graph.depth
    order = None
    for _ in range(5):
        # Subtree-contiguous orders never revisit an evicted block, so the
        # schedule's bytes equal the prediction's loaded bytes exactly.
        order = sorted(rng.permutation(graph.num_tasks)[: int(rng.integers(1, 7))])
        loads = cm.plan_loads(order, resident)
        assert loads == rcm.plan_loads(order, resident)
        predicted = cm.predicted_stats(order, resume=resident)
        _same_stats(predicted, rcm.predicted_stats(order, resume=resident))
        assert sum(PORT.block_costs[d].weight_bytes for d, _n in loads) == \
            predicted.weight_bytes_loaded
        assert len({node for _d, node in loads}) == len(loads)
        resident = cm.residency_after(order, resident)
    assert cm.plan_loads([order[-1]], resident) == []


def test_plan_loads_dedupes_revisited_blocks():
    """An interleaved order evicts and re-loads shared prefix blocks; the
    prediction pays both loads but the streamer stages one copy."""
    cm, rcm = _cost_models()
    order = [0, 3, 1]
    loads = cm.plan_loads(order)
    assert loads == rcm.plan_loads(order)
    assert len({node for _d, node in loads}) == len(loads)
    predicted = cm.predicted_stats(order)
    scheduled = sum(PORT.block_costs[d].weight_bytes for d, _n in loads)
    revisit = sum(PORT.block_costs[d].weight_bytes for d in (1, 2))
    assert predicted.weight_bytes_loaded - scheduled == revisit
    xs = _inputs(0, 2)
    ex, rex = TaskGraphExecutor(PORT), RExecutor(REF)
    ex.streamer.stage(loads)
    rex.streamer.stage(loads)
    out, stats = ex.run_batch(torch.as_tensor(xs), order)
    rout, rstats = rex.run_batch(jnp.asarray(xs), order)
    assert stats.prefetched_bytes == scheduled
    assert stats.weight_bytes_loaded == predicted.weight_bytes_loaded
    _same_stats(stats, rstats)
    _same_outputs(out, rout)


def test_plan_loads_rejects_bad_residency_length():
    cm, _ = _cost_models()
    with pytest.raises(ValueError, match="slots"):
        cm.plan_loads([0], (None,) * (PORT.graph.depth + 1))


def test_prefetch_stall_is_load_seconds_minus_overlap():
    cm, rcm = _cost_models()
    depths = [0, 2, 3]
    total = sum(cm.load_cost(d) for d in depths)
    for window in (0.0, total / 2, 10 * total, -1.0):
        assert cm.prefetch_stall_seconds(depths, window) == \
            rcm.prefetch_stall_seconds(depths, window)
    assert cm.prefetch_stall_seconds(depths, 0.0) == pytest.approx(total)
    assert cm.prefetch_stall_seconds(depths, total / 2) == pytest.approx(total / 2)
    assert cm.prefetch_stall_seconds(depths, 10 * total) == 0.0
    assert cm.prefetch_stall_seconds(depths, -1.0) == pytest.approx(total)
    assert cm.prefetch_stall_seconds([], 0.0) == 0.0


def test_plan_predictor_overlap_marks_loads_prefetched():
    cm, rcm = _cost_models()
    sync, streamed = cm.plan_predictor(), cm.plan_predictor()
    r_streamed = rcm.plan_predictor()
    orders = ([0, 1], [3, 4], [2, 0], [5])
    for i, order in enumerate(orders):
        loads = cm.plan_loads(order, streamed.residency)
        d_sync = sync.append(order, batch_size=2)
        overlap = None if i == 0 else 1e9
        d_strm = streamed.append(order, batch_size=2, overlap_seconds=overlap)
        _same_stats(d_strm, r_streamed.append(order, batch_size=2, overlap_seconds=overlap))
        assert d_strm.weight_bytes_loaded == d_sync.weight_bytes_loaded
        if overlap is None:
            assert d_strm.prefetched_bytes == 0.0
        else:
            assert d_strm.prefetched_bytes == d_strm.weight_bytes_loaded == \
                sum(PORT.block_costs[d].weight_bytes for d, _n in loads)
            assert d_strm.stream_stall_seconds == 0.0
    assert streamed.stats.weight_bytes_loaded == sync.stats.weight_bytes_loaded
    first = cm.predicted_stats(orders[0], batch_size=2)
    assert streamed.stats.prefetched_bytes == \
        streamed.stats.weight_bytes_loaded - first.weight_bytes_loaded
    tight, r_tight = cm.plan_predictor(), rcm.plan_predictor()
    tight.append(orders[0], batch_size=2)
    r_tight.append(orders[0], batch_size=2)
    loads = cm.plan_loads(orders[1], tight.residency)
    load_s = sum(cm.load_cost(d) for d, _n in loads)
    delta = tight.append(orders[1], batch_size=2, overlap_seconds=load_s / 4)
    _same_stats(delta, r_tight.append(orders[1], batch_size=2, overlap_seconds=load_s / 4))
    assert delta.stream_stall_seconds == pytest.approx(0.75 * load_s)


def test_stats_seconds_subtracts_prefetched_and_adds_stall():
    kw = dict(flops_executed=1e6, weight_bytes_loaded=8e5,
              prefetched_bytes=6e5, stream_stall_seconds=0.01)
    base = ExecutionStats(flops_executed=1e6, weight_bytes_loaded=8e5)
    streamed, r_streamed = ExecutionStats(**kw), RStats(**kw)
    assert streamed.compute_seconds(MSP430) == r_streamed.compute_seconds(R_MSP430)
    assert streamed.seconds(MSP430) == r_streamed.seconds(R_MSP430)
    assert streamed.seconds(MSP430) == pytest.approx(
        MSP430.exec_seconds(1e6) + MSP430.load_seconds(2e5) + 0.01)
    assert streamed.seconds(MSP430) < base.seconds(MSP430)
    merged = base.merge(streamed)
    assert merged.prefetched_bytes == 6e5
    assert merged.stream_stall_seconds == pytest.approx(0.01)


# --------------------------------------------------------------------------
# WeightStreamer: staging slots, commit-on-use, cancellation
# --------------------------------------------------------------------------

def test_streamer_commit_on_use_cycle():
    cm, _ = _cost_models()
    ex = TaskGraphExecutor(PORT)
    loads = cm.plan_loads([0, 1], ex.residency_state())
    st = ex.streamer
    st.stage(loads, stall_seconds=0.25)
    assert st.staged_nodes() == {node for _d, node in loads}
    assert st.pending_stall_seconds == 0.25
    _d0, n0 = loads[0]
    assert st.commit(n0) is True
    assert st.commit(n0) is False
    assert st.commit((0, (9,))) is False
    assert n0 not in st.staged_nodes()
    # The committed copy is a copy: equal values, its own storage.
    committed = ex._streamed_node[n0]
    assert torch.equal(committed, PORT.node_params[n0])
    assert committed.data_ptr() != PORT.node_params[n0].data_ptr()
    assert st.finish_group() == 0.25
    assert st.finish_group() == 0.0
    assert st.staged_nodes() == frozenset()


def test_streamer_unconsumed_batch_charges_no_stall():
    cm, _ = _cost_models()
    ex = TaskGraphExecutor(PORT)
    ex.streamer.stage(cm.plan_loads([3], ex.residency_state()), 0.5)
    assert ex.streamer.finish_group() == 0.0


def test_streamer_restage_replaces_previous_batch():
    cm, _ = _cost_models()
    ex = TaskGraphExecutor(PORT)
    first = cm.plan_loads([0], ex.residency_state())
    second = cm.plan_loads([5], ex.residency_state())
    st = ex.streamer
    st.stage(first, 0.1)
    st.stage(second, 0.2)
    assert st.staged_nodes() == {node for _d, node in second}
    assert st.pending_stall_seconds == 0.2
    assert st.cancels == 1


def test_executor_prefetch_counts_bytes_and_keeps_outputs():
    cm, _ = _cost_models()
    xs = _inputs(7, 3)
    order = [0, 1, 2]
    ref_out, ref_stats = TaskGraphExecutor(PORT).run_batch(torch.as_tensor(xs), order)
    ex, rex = TaskGraphExecutor(PORT), RExecutor(REF)
    loads = cm.plan_loads(order, ex.residency_state())
    ex.streamer.stage(loads, stall_seconds=0.125)
    rex.streamer.stage(loads, stall_seconds=0.125)
    out, stats = ex.run_batch(torch.as_tensor(xs), order)
    rout, rstats = rex.run_batch(jnp.asarray(xs), order)
    for t in ref_out:
        # The streamed copies hold the same values: the same bits come out.
        assert torch.equal(out[t], ref_out[t])
    _same_outputs(out, rout)
    _same_stats(stats, rstats)
    assert stats.prefetched_bytes == stats.weight_bytes_loaded == \
        ref_stats.weight_bytes_loaded
    assert ex.streamer.finish_group() == 0.125
    # Committed copies back the resident nodes; an evicted node's copy went
    # with its eviction (the reference keeps it until the next residency
    # boundary; on the card it would be device memory for nothing).
    resident = set(ex.residency_state())
    assert set(ex._streamed_node) == {node for _d, node in loads if node in resident}
    assert set(rex._streamed_node) == {node for _d, node in loads}


# --------------------------------------------------------------------------
# Residency edge cases: mismatched depth, restore-then-prefetch, rollback
# --------------------------------------------------------------------------

def test_set_residency_rejects_mismatched_depth():
    ex = TaskGraphExecutor(PORT)
    depth = PORT.graph.depth
    before = ex.residency_state()
    for bad in ((None,) * (depth - 1), (None,) * (depth + 1), ()):
        with pytest.raises(ValueError, match="slots"):
            ex.set_residency(bad)
    assert ex.residency_state() == before


def test_restore_cancels_inflight_prefetch():
    cm, rcm = _cost_models()
    xs = _inputs(3, 2)
    ex = TaskGraphExecutor(PORT)
    ex.run_batch(torch.as_tensor(xs), [0, 1])
    snapshot = ex.residency_state()
    ex.streamer.stage(cm.plan_loads([3, 4], snapshot), stall_seconds=0.5)
    ex.set_residency(snapshot)
    assert ex.streamer.staged_nodes() == frozenset()
    assert ex.streamer.pending_stall_seconds == 0.0
    assert ex.streamer.cancels == 1
    resume = ex.residency_state()
    _out, stats = ex.run_batch(torch.as_tensor(xs), [3, 4])
    predicted = cm.predicted_stats([3, 4], batch_size=2, resume=resume)
    assert stats == predicted
    _same_stats(predicted, rcm.predicted_stats([3, 4], batch_size=2, resume=resume))
    assert stats.prefetched_bytes == 0.0 and stats.stream_stall_seconds == 0.0


def test_reset_drops_streamed_state():
    cm, _ = _cost_models()
    ex = TaskGraphExecutor(PORT)
    ex.streamer.stage(cm.plan_loads([0], ex.residency_state()), 0.1)
    ex.run_batch(torch.as_tensor(_inputs(5, 1)), [0])
    assert ex._streamed_node
    ex.reset()
    assert ex.streamer.staged_nodes() == frozenset()
    assert ex._streamed_node == {}
    assert ex.streamer.pending_stall_seconds == 0.0


def _engines(streaming, shapes=(1, 2, 4), **kw):
    port = MultitaskEngine(PORT, hw=MSP430, policy=EnginePolicy(streaming=streaming),
                           scheduler=RequestGroupScheduler(batch_shapes=shapes),
                           **kw.get("port", {}))
    ref = REngine(REF, hw=R_MSP430, policy=REnginePolicy(streaming=streaming),
                  scheduler=RScheduler(batch_shapes=shapes), **kw.get("ref", {}))
    return port, ref


def _drain(engine, requests, **session_kw):
    session = engine.session(**session_kw)
    futures = [session.submit(r) for r in requests]
    session.drain()
    return session, futures


def test_rollback_mid_prefetch_leaves_no_half_committed_residency():
    """A group that crashes after committing part of its prefetched stream
    rolls back with nothing streamed left behind; counters stay exact and
    equal to the reference's through the recovery."""
    injector, r_injector = (FaultInjector(script={"dispatch": (2,)}),
                            RFaultInjector(script={"dispatch": (2,)}))
    eng, reng = _engines(True, shapes=(1, 2), port={"fault_injector": injector},
                         ref={"fault_injector": r_injector})
    reqs, rreqs = _requests(11, 8)
    session, futures = _drain(eng, reqs, retry=RetryPolicy(max_retries=2, degrade=True))
    rsession, rfutures = _drain(reng, rreqs, retry=RRetry(max_retries=2, degrade=True))
    assert injector.total_injected == 1
    assert all(f.done() and f.error() is None for f in futures)
    assert session.stats == session.predicted
    assert session.group_retries >= 1
    st = eng.executor.streamer
    assert st.staged_nodes() == frozenset()
    assert st.pending_stall_seconds == 0.0
    assert st.cancels >= 1
    _same_stats(session.stats, rsession.stats)
    assert (session.group_retries, st.cancels) == \
        (rsession.group_retries, reng.executor.streamer.cancels)
    solo = MultitaskEngine(PORT, hw=MSP430, warm_start=False, group_ordering=False,
                           scheduler=RequestGroupScheduler(batch_shapes=(1,)))
    for f, rf, req in zip(futures, rfutures, reqs):
        ref = solo.serve(MultitaskRequest(x=req.x, tasks=req.tasks))
        _same_outputs(f.result().outputs, {t: y.numpy() for t, y in ref.outputs.items()},
                      SOLO_TOL)
        _same_outputs(f.result().outputs, rf.result().outputs, SOLO_TOL)


# --------------------------------------------------------------------------
# Serving pipeline: streamed sessions vs synchronous sessions
# --------------------------------------------------------------------------

def test_streaming_session_matches_synchronous():
    reqs, rreqs = _requests(2, 12)
    (sync_eng, _), (strm_eng, r_strm_eng) = _engines(False), _engines(True)
    sync, sync_f = _drain(sync_eng, reqs)
    strm, strm_f = _drain(strm_eng, reqs)
    r_strm, r_strm_f = _drain(r_strm_eng, rreqs)
    for a, b, r in zip(sync_f, strm_f, r_strm_f):
        a, b = a.result(), b.result()
        assert set(a.outputs) == set(b.outputs)
        for t in a.outputs:
            # The committed copies hold the same values: the same bits.
            assert torch.equal(b.outputs[t], a.outputs[t])
        _same_outputs(b.outputs, r.result().outputs)
    assert sync.stats == sync.predicted
    assert strm.stats == strm.predicted
    _same_stats(strm.stats, r_strm.stats)
    _same_stats(strm.predicted, r_strm.predicted)
    assert strm.stats.weight_bytes_loaded == sync.stats.weight_bytes_loaded
    assert strm.stats.prefetched_bytes > 0.0
    assert sync.stats.prefetched_bytes == 0.0
    assert strm.prefetches_issued == r_strm.prefetches_issued > 0
    assert strm.prefetch_scheduled_bytes == strm.stats.prefetched_bytes
    assert strm.stats.seconds(MSP430) <= sync.stats.seconds(MSP430)


def test_streaming_requires_warm_start():
    with pytest.raises(ValueError, match="warm_start"):
        MultitaskEngine(PORT, hw=MSP430,
                        policy=EnginePolicy(streaming=True, warm_start=False))
    cold = MultitaskEngine(PORT, hw=MSP430, warm_start=False)
    with pytest.raises(ValueError, match="warm-start"):
        cold.session(streaming=True)


def test_session_streaming_kwarg_overrides_policy():
    reqs, rreqs = _requests(4, 8)
    eng, reng = _engines(True)
    session, _ = _drain(eng, reqs, streaming=False)
    rsession, _ = _drain(reng, rreqs, streaming=False)
    assert session.stats == session.predicted
    assert session.stats.prefetched_bytes == 0.0
    assert session.prefetches_issued == 0
    _same_stats(session.stats, rsession.stats)


def test_prefetch_fault_degrades_to_synchronous_loads():
    injector, r_injector = (FaultInjector(script={"prefetch": (0, 1)}),
                            RFaultInjector(script={"prefetch": (0, 1)}))
    eng, reng = _engines(True, port={"fault_injector": injector},
                         ref={"fault_injector": r_injector})
    reqs, rreqs = _requests(6, 12)
    session, futures = _drain(eng, reqs)
    rsession, rfutures = _drain(reng, rreqs)
    assert injector.injected["prefetch"] == 2
    assert session.prefetch_failures == 2
    assert isinstance(session.last_prefetch_error, InjectedFault)
    assert session.last_prefetch_error.site == "prefetch"
    assert all(f.result() is not None for f in futures)
    assert session.requests_failed == 0
    assert session.stats == session.predicted
    assert session.prefetches_issued > 0
    assert session.stats.prefetched_bytes > 0.0
    _same_stats(session.stats, rsession.stats)
    assert (session.prefetch_failures, session.prefetches_issued) == \
        (rsession.prefetch_failures, rsession.prefetches_issued)
    for f, rf in zip(futures, rfutures):
        _same_outputs(f.result().outputs, rf.result().outputs)


def test_prefetch_errors_other_than_injected_faults_raise():
    """No quiet fallback: only an injected ``"prefetch"`` fault degrades to
    synchronous loads; a failing copy reaches the caller."""
    eng, _ = _engines(True)

    def broken(*_a, **_k):
        raise RuntimeError("copy failed")

    eng.executor.streamer.stage = broken
    reqs, _ = _requests(6, 12)
    with pytest.raises(RuntimeError, match="copy failed"):
        _drain(eng, reqs)


def test_streaming_with_gates_stays_self_consistent():
    """A gated streamed run counts only committed bytes and matches the
    synchronous gated run's outputs (and the reference's counters)."""
    gates = {1: lambda outs: bool(np.asarray(outs[0])[0] > 0) if 0 in outs else True}
    reqs, rreqs = _requests(9, 10)
    runs = []
    for streaming in (False, True):
        eng, reng = _engines(streaming, shapes=(1, 2), port={"gates": gates},
                             ref={"gates": gates})
        session, futures = _drain(eng, reqs)
        rsession, rfutures = _drain(reng, rreqs)
        _same_stats(session.stats, rsession.stats)
        for f, rf in zip(futures, rfutures):
            _same_outputs(f.result().outputs, rf.result().outputs)
        runs.append((session, [f.result() for f in futures]))
    (s0, r0), (s1, r1) = runs
    for a, b in zip(r0, r1):
        assert set(a.outputs) == set(b.outputs)
        for t in a.outputs:
            assert torch.equal(b.outputs[t], a.outputs[t])
    assert s1.stats.weight_bytes_loaded == s0.stats.weight_bytes_loaded
    assert s1.stats.prefetched_bytes <= s1.stats.weight_bytes_loaded
