"""The port's intermittent-power serving — the write-ahead journal,
power-failure-atomic checkpoint/resume and the energy budget — re-pointed
from ``tests/test_intermittent.py`` and held against the JAX package.

The contract under test:

* the journal is a write-ahead log on a store that outlives the session:
  replay is an idempotent fold and the first commit per group wins; the
  file store round-trips every payload bit-exactly, bf16 included;
* cutting a suffix at checkpoint depths changes neither outputs nor
  counters, and fires one hook per cut;
* a suffix interrupted at depth d resumes from d+1, not 0;
* :meth:`ServingSession.recover` rebuilds a session with exactly-once
  responses, outputs matching the uninterrupted run, and
  ``session.stats == session.predicted`` (checkpoint terms included) across
  any number of reboots;
* the :class:`EnergyBudget` duty-cycles the pump and isolates infeasible
  groups.

Against the reference: the same weights (one ``np.random.default_rng`` in
the reference's order, or the reference's LeNet-5 carried over), the same
requests and the same power-failure scripts (seeded injectors included)
give the same checkpoint plans, the same counters field for field, the
same session counters, and equal replayed :class:`JournalState` — the same
admissions, terminal seqs, responses (counters exact, outputs within fp32
1e-5 relative + 1e-5 absolute, the cross-package tolerance of
``tests/test_torch_session.py``), residency, in-flight group, checkpoint
and next group id.  The port against its own uninterrupted run: the
reference test's 1e-5 relative + 1e-6 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockCost as RBlockCost
from repro.core import GraphCostModel as RCostModel
from repro.core import MSP430 as R_MSP430
from repro.core import MultitaskProgram as RProgram
from repro.core.executor import TaskGraphExecutor as RExecutor
from repro.core.task_graph import TaskGraph as RTaskGraph
from repro.core.types import ExecutionStats as RStats
from repro.models import multitask as r_mt
from repro.serving import EnergyBudget as REnergyBudget
from repro.serving import EnginePolicy as REnginePolicy
from repro.serving import Journal as RJournal
from repro.serving import MemoryJournalStore as RMemoryStore
from repro.serving import MultitaskEngine as REngine
from repro.serving import MultitaskRequest as RRequest
from repro.serving import PowerFailure as RPowerFailure
from repro.serving import PowerFailureInjector as RInjector
from repro.serving import RequestGroupScheduler as RScheduler
from repro.serving import ServingSession as RSession
from repro_torch.core import BlockCost, GraphCostModel, MSP430, MultitaskProgram
from repro_torch.core.executor import ActivationCheckpoint, TaskGraphExecutor
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import ExecutionStats
from repro_torch.models import multitask as p_mt
from repro_torch.serving import (
    EnergyBudget, EnginePolicy, FileJournalStore, Journal, MemoryJournalStore,
    MultitaskEngine, MultitaskRequest, PowerFailure, PowerFailureInjector,
    RequestGroupScheduler, ServingSession,
)

DIM = 8
GROUPS = [[[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]]]
GRAPH = TaskGraph.from_groups(GROUPS)
SELF_TOL = dict(rtol=1e-5, atol=1e-6)     # the reference test's own
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)   # port vs reference, fp32


def _programs(seed=0, act_bytes=8.0):
    """The reference test's program in both packages, one set of weights."""
    rgraph = RTaskGraph.from_groups(GROUPS)
    rng = np.random.default_rng(seed)
    costs = [(100.0 * (d + 1), 1e4 * (d + 1)) for d in range(GRAPH.depth)]
    nodes = {n: rng.normal(size=(DIM, DIM)).astype(np.float32) for n in rgraph.nodes()}
    heads = [rng.normal(size=(DIM, 3)).astype(np.float32) for _ in range(GRAPH.num_tasks)]
    port = MultitaskProgram(
        GRAPH, [lambda p, x: torch.tanh(x @ p)] * GRAPH.depth,
        {n: torch.as_tensor(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * GRAPH.num_tasks, [torch.as_tensor(h) for h in heads],
        [BlockCost(weight_bytes=w, flops=f, act_bytes=act_bytes) for w, f in costs],
    )
    ref = RProgram(
        rgraph, [lambda p, x: jnp.tanh(x @ p)] * rgraph.depth,
        {n: jnp.asarray(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * rgraph.num_tasks, [jnp.asarray(h) for h in heads],
        [RBlockCost(weight_bytes=w, flops=f, act_bytes=act_bytes) for w, f in costs],
    )
    return port, ref


PROGRAM, REF = _programs()
PORT_API = dict(engine=MultitaskEngine, policy=EnginePolicy, sched=RequestGroupScheduler,
                hw=MSP430, session=ServingSession, journal=Journal,
                store=MemoryJournalStore, failure=PowerFailure,
                request=MultitaskRequest, x=torch.as_tensor)
REF_API = dict(engine=REngine, policy=REnginePolicy, sched=RScheduler, hw=R_MSP430,
               session=RSession, journal=RJournal, store=RMemoryStore,
               failure=RPowerFailure, request=RRequest, x=jnp.asarray)


def _engine(api, prog, **kw):
    kw.setdefault("scheduler", api["sched"](batch_shapes=(1, 2, 4)))
    return api["engine"](prog, hw=api["hw"], policy=api["policy"](warm_start=True), **kw)


def _xs(n, seed):
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _requests(api, n=6, seed=1, tasks=None):
    return [api["request"](x=api["x"](x), tasks=tasks) for x in _xs(n, seed)]


def _baseline(api, prog, reqs):
    """Uninterrupted journaled serve: the outputs to match."""
    session = api["session"](_engine(api, prog), journal=api["journal"](api["store"]()))
    futs = [session.submit(r) for r in reqs]
    session.drain()
    assert session.stats == session.predicted
    return {f.seq: f.result().outputs for f in futs}


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


def _assert_outputs_match(got, ref, tol=SELF_TOL):
    assert set(got) == set(ref)
    for t in ref:
        np.testing.assert_allclose(_np(got[t]), _np(ref[t]), **tol)


def _same_stats(port, ref):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def assert_same_journal_state(port, ref):
    """Two replayed JournalStates are equal: payloads within PARITY_TOL,
    everything else exactly."""
    assert sorted(port.admitted) == sorted(ref.admitted)
    for seq, rec in ref.admitted.items():
        got = port.admitted[seq]
        for key in ("seq", "tasks", "deadline", "priority", "tenant"):
            assert got[key] == rec[key], key
        np.testing.assert_allclose(_np(got["x"]), _np(rec["x"]), rtol=0, atol=0)
    assert port.terminal == ref.terminal
    assert sorted(port.responses) == sorted(ref.responses)
    for seq, rec in ref.responses.items():
        got = port.responses[seq]
        assert (got["group_id"], got["group_size"]) == (rec["group_id"], rec["group_size"])
        _same_stats(got["stats"], rec["stats"])
        _assert_outputs_match(got["outputs"], rec["outputs"], PARITY_TOL)
    assert port.residency == ref.residency
    if ref.inflight is None:
        assert port.inflight is None
    else:
        assert port.inflight == ref.inflight
    if ref.checkpoint is None:
        assert port.checkpoint is None
    else:
        for key in ("kind", "group_id", "pos", "task", "depth", "node", "act_shape"):
            assert port.checkpoint[key] == ref.checkpoint[key], key
        np.testing.assert_allclose(_np(port.checkpoint["value"]), _np(ref.checkpoint["value"]),
                                   **PARITY_TOL)
    assert port.next_group_id == ref.next_group_id
    assert port.pending_seqs == ref.pending_seqs


# --------------------------------------------------------------------------
# Journal: replay idempotence, exactly-once, file-backed store
# --------------------------------------------------------------------------

def _write_replay_script(journal, stats_cls, arr):
    x = arr(np.ones(DIM, np.float32))
    journal.admit(0, x, None, deadline=None, priority=0, tenant=None)
    journal.admit(1, x, (0, 1), deadline=1.5, priority=2, tenant="acme")
    journal.admit(1, x, (0, 1), deadline=1.5, priority=2, tenant="acme")  # dup
    journal.group_begin(0, [0, 1], [0, 1], 2)
    out = [{0: arr(np.zeros(3, np.float32))}, {1: arr(np.ones(3, np.float32))}]
    journal.group_commit(0, [0, 1], out, [None] * GRAPH.depth, stats_cls())
    # Duplicate commit with DIFFERENT outputs: exactly-once means ignored.
    journal.group_commit(0, [0, 1], [{0: arr(np.full(3, 9.0, np.float32))},
                                     {1: arr(np.full(3, 9.0, np.float32))}],
                         [None] * GRAPH.depth, stats_cls())


def test_replay_is_idempotent_and_first_commit_wins():
    j = Journal(MemoryJournalStore())
    _write_replay_script(j, ExecutionStats, torch.as_tensor)
    rj = RJournal(RMemoryStore())
    _write_replay_script(rj, RStats, np.asarray)
    a, b = j.replay(), j.replay()
    assert set(a.admitted) == {0, 1}
    assert a.admitted[1]["tenant"] == "acme"
    assert a.inflight is None
    assert set(a.responses) == {0, 1}
    assert torch.equal(a.responses[0]["outputs"][0], torch.zeros(3))
    assert set(b.responses) == set(a.responses)
    assert b.pending_seqs == a.pending_seqs == []
    assert_same_journal_state(a, rj.replay())


def test_replay_recovers_inflight_group_and_latest_checkpoint():
    j, rj = Journal(MemoryJournalStore()), RJournal(RMemoryStore())
    for journal, arr in ((j, torch.as_tensor), (rj, np.asarray)):
        x = arr(np.ones(DIM, np.float32))
        for s in range(3):
            journal.admit(s, x, None, deadline=None, priority=0, tenant=None)
        journal.group_begin(7, [0, 2], [2, 0], 2)
        journal.checkpoint(7, 0, 2, 0, GRAPH.path(2)[0], arr(np.ones((2, DIM), np.float32)),
                           (2, DIM))
        journal.checkpoint(7, 0, 2, 1, GRAPH.path(2)[1], arr(np.ones((2, DIM), np.float32)),
                           (2, DIM))
    st = j.replay()
    assert st.inflight["group_id"] == 7
    assert [int(s) for s in st.inflight["seqs"]] == [0, 2]
    assert st.checkpoint["depth"] == 1          # latest wins
    assert st.checkpoint_node() == GRAPH.path(2)[1]
    assert st.pending_seqs == [0, 1, 2]
    assert st.next_group_id == 8
    assert_same_journal_state(st, rj.replay())


def test_file_journal_store_roundtrip(tmp_path):
    """The JSONL store survives process death: a fresh store over the same
    path replays to identical state, arrays and tensors included."""
    path = str(tmp_path / "journal.jsonl")
    j = Journal(FileJournalStore(path))
    x = np.arange(DIM, dtype=np.float32)
    j.admit(0, x, (0, 2), deadline=2.5, priority=1, tenant="t0")
    j.group_begin(0, [0], [0, 2], 1)
    j.checkpoint(0, 0, 0, 1, GRAPH.path(0)[1], torch.full((1, DIM), 0.25), (1, DIM))
    stats = ExecutionStats(flops_executed=12.0, checkpoint_bytes=8.0,
                           checkpoint_seconds=1e-6)
    j.group_commit(0, [0], [{0: torch.full((3,), 2.0)}],
                   [GRAPH.path(0)[0]] + [None] * (GRAPH.depth - 1), stats)
    st = Journal(FileJournalStore(path)).replay()
    np.testing.assert_array_equal(st.admitted[0]["x"], x)
    assert st.admitted[0]["deadline"] == 2.5
    rec = st.responses[0]
    assert rec["stats"] == stats
    assert torch.equal(rec["outputs"][0], torch.full((3,), 2.0))
    assert st.residency[0] == GRAPH.path(0)[0]
    assert st.inflight is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32,
                                   torch.float64, torch.int32, torch.bool])
def test_file_journal_store_tensors_roundtrip_bit_exactly(tmp_path, dtype):
    """Tensors go through the file store as their bits with a dtype tag:
    bf16 (which numpy cannot hold without ml_dtypes) included, NaN, inf and
    negative zero too."""
    vals = torch.tensor([[0.0, -0.0, 1.0 / 3.0, -2.5e-3, 65504.0, float("inf"),
                          float("nan"), 1e-40]], dtype=torch.float64)
    t = (vals.nan_to_num(0.0).to(dtype) if not dtype.is_floating_point
         else vals.to(dtype))
    path = str(tmp_path / "j.jsonl")
    j = Journal(FileJournalStore(path))
    j.group_begin(0, [0], [0], 1)
    j.checkpoint(0, 0, 0, 1, GRAPH.path(0)[1], t, tuple(t.shape))
    back = Journal(FileJournalStore(path)).replay().checkpoint["value"]
    assert back.dtype == dtype and back.shape == t.shape
    if dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        assert torch.equal(back.view(bits), t.view(bits))
    else:
        assert torch.equal(back, t)


# --------------------------------------------------------------------------
# Executor: segmented suffixes, activation checkpoint/restore
# --------------------------------------------------------------------------

def test_segmented_suffix_matches_unsegmented():
    xs = _xs(2, 3)
    plain_ex, seg_ex, rseg_ex = (TaskGraphExecutor(PROGRAM), TaskGraphExecutor(PROGRAM),
                                 RExecutor(REF))
    for task in range(GRAPH.num_tasks):
        plain_ex.clear_activations()
        seg_ex.clear_activations()
        rseg_ex.clear_activations()
        s_plain, s_seg, r_seg = ExecutionStats(), ExecutionStats(), RStats()
        ref = plain_ex.run_task_batch(task, torch.as_tensor(xs), s_plain)
        fired, r_fired = [], []
        got = seg_ex.run_task_batch(task, torch.as_tensor(xs), s_seg, checkpoint_depths=(0, 1),
                                    checkpoint_hook=fired.append)
        r_got = rseg_ex.run_task_batch(task, jnp.asarray(xs), r_seg, checkpoint_depths=(0, 1),
                                       checkpoint_hook=r_fired.append)
        # The cut runs the same ops in the same order: the same bits.
        assert torch.equal(got, ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(r_got), **PARITY_TOL)
        assert s_plain == s_seg
        _same_stats(s_seg, r_seg)
        assert fired == r_fired == [0, 1]
        assert seg_ex.dispatch_count == rseg_ex.dispatch_count
    seg_ex.reset()
    fired = []
    seg_ex.run_task_batch(0, torch.as_tensor(xs), ExecutionStats(),
                          checkpoint_depths=(GRAPH.depth - 1,), checkpoint_hook=fired.append)
    assert fired == []


def test_segmented_suffix_on_the_unfused_path_fires_the_same_hooks():
    xs = torch.as_tensor(_xs(2, 3))
    ref = TaskGraphExecutor(PROGRAM).run_task_batch(1, xs, ExecutionStats())
    ex = TaskGraphExecutor(PROGRAM, fused=False)
    fired = []
    got = ex.run_task_batch(1, xs, ExecutionStats(), checkpoint_depths=(0, 1),
                            checkpoint_hook=fired.append)
    assert fired == [0, 1]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **SELF_TOL)


def test_activation_checkpoint_restore_resumes_mid_path():
    xs = _xs(2, 4)
    for ex, x, stats_cls in ((TaskGraphExecutor(PROGRAM), torch.as_tensor(xs), ExecutionStats),
                             (RExecutor(REF), jnp.asarray(xs), RStats)):
        ref = ex.run_task_batch(0, x, stats_cls())
        ck = ex.activation_checkpoint(0)
        assert ck is not None and ck.depth == GRAPH.depth - 1
        assert ck.node == GRAPH.path(0)[ck.depth]
        residency = ex.residency_state()
        ex.reset()
        ex.set_residency(residency)
        ex.restore_activation(ck)
        stats = stats_cls()
        got = ex.run_task_batch(0, x, stats)
        np.testing.assert_allclose(_np(got) if isinstance(got, torch.Tensor) else got,
                                   _np(ref) if isinstance(ref, torch.Tensor) else ref,
                                   rtol=1e-6, atol=1e-6)
        assert stats.blocks_skipped == ck.depth + 1
        assert stats.blocks_executed == GRAPH.depth - ck.depth - 1
        assert stats.weight_bytes_loaded == 0.0


def test_restore_activation_keeps_dtype_on_the_program_device():
    """A journaled bf16 activation comes back in bf16, bit for bit."""
    ex = TaskGraphExecutor(PROGRAM)
    value = torch.randn(2, DIM, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    node = GRAPH.path(2)[1]
    ex.restore_activation(ActivationCheckpoint(1, node, value, (2, DIM)))
    ck = ex.activation_checkpoint(2)
    assert ck.depth == 1 and ck.value.dtype == torch.bfloat16
    assert torch.equal(ck.value.view(torch.int16), value.view(torch.int16))


def test_prediction_tracks_resume_and_activation_floor():
    """``first_task_resume`` prediction matches execution exactly, including
    the activation floor after a mid-path restore."""
    xs = _xs(2, 5)
    order = [1, 2]
    cm = GraphCostModel(GRAPH, PROGRAM.block_costs, MSP430)
    rcm = RCostModel(REF.graph, REF.block_costs, R_MSP430)
    results = []
    for ex, x, stats_cls in ((TaskGraphExecutor(PROGRAM), torch.as_tensor(xs), ExecutionStats),
                             (RExecutor(REF), jnp.asarray(xs), RStats)):
        ex.run_task_batch(1, x, stats_cls())
        ck = ex.activation_checkpoint(1)
        residency = ex.residency_state()
        ex.reset()
        ex.set_residency(residency)
        ex.restore_activation(ck)
        stats = stats_cls()
        for t in order:
            ex.run_task_batch(t, x, stats, weight=2)
        results.append((stats, residency, ck.depth))
    (stats, residency, depth), (rstats, _, rdepth) = results
    predicted = cm.predicted_stats(order, batch_size=2, resume=residency,
                                   first_task_resume=depth + 1)
    assert stats == predicted
    _same_stats(stats, rstats)
    _same_stats(predicted, rcm.predicted_stats(order, batch_size=2, resume=residency,
                                               first_task_resume=rdepth + 1))


# --------------------------------------------------------------------------
# Cost model: checkpoint placement
# --------------------------------------------------------------------------

def test_checkpoint_placement_follows_write_vs_reexec_rule():
    cm = GraphCostModel(GRAPH, PROGRAM.block_costs, MSP430, metric="energy")
    rcm = RCostModel(REF.graph, REF.block_costs, R_MSP430, metric="energy")
    sites = cm.plan_checkpoints([2, 3], batch_size=2)
    assert sites
    assert [dataclasses.asdict(s) for s in sites] == \
        [dataclasses.asdict(s) for s in rcm.plan_checkpoints([2, 3], batch_size=2)]
    for s in sites:
        assert 0 <= s.depth < GRAPH.depth - 1
        assert s.bytes == cm.checkpoint_bytes(s.depth, 2)
        assert s.seconds == cm.checkpoint_write_seconds(s.depth, 2)
    costly = GraphCostModel(
        GRAPH, [dataclasses.replace(bc, act_bytes=1e9) for bc in PROGRAM.block_costs],
        MSP430, metric="energy",
    )
    assert costly.plan_checkpoints([2, 3], batch_size=2) == []
    for first in (0, 1, 2):
        assert [dataclasses.asdict(s) for s in cm.plan_checkpoints(
            [3, 0, 1], batch_size=3, first_task_resume=first)] == \
            [dataclasses.asdict(s) for s in rcm.plan_checkpoints(
                [3, 0, 1], batch_size=3, first_task_resume=first)]


def test_predicted_stats_accounts_planned_checkpoints():
    cm = GraphCostModel(GRAPH, PROGRAM.block_costs, MSP430, metric="energy")
    rcm = RCostModel(REF.graph, REF.block_costs, R_MSP430, metric="energy")
    sites = cm.plan_checkpoints([0, 1], batch_size=2)
    base = cm.predicted_stats([0, 1], batch_size=2)
    with_ck = cm.predicted_stats([0, 1], batch_size=2, checkpoints=sites)
    _same_stats(with_ck, rcm.predicted_stats(
        [0, 1], batch_size=2, checkpoints=rcm.plan_checkpoints([0, 1], batch_size=2)))
    assert with_ck.checkpoint_bytes == sum(s.bytes for s in sites) > 0
    assert with_ck.checkpoint_seconds == pytest.approx(sum(s.seconds for s in sites))
    assert base.checkpoint_bytes == 0.0
    assert with_ck.flops_executed == base.flops_executed
    assert with_ck.seconds(MSP430) > base.seconds(MSP430)
    assert with_ck.energy(MSP430) > base.energy(MSP430)
    pred = cm.plan_predictor()
    delta = pred.append([0, 1], batch_size=2, checkpoints=sites, first_task_resume=0)
    assert delta == with_ck


# --------------------------------------------------------------------------
# Power-failure injection
# --------------------------------------------------------------------------

def test_power_injector_script_and_cap():
    inj = PowerFailureInjector(script={"group": [1]}, max_failures=1)
    inj.check("group")
    with pytest.raises(PowerFailure) as e:
        inj.check("group", task=3)
    assert e.value.site == "group" and e.value.index == 1
    assert e.value.context["task"] == 3
    assert not isinstance(e.value, Exception)
    inj.check("group")
    assert inj.total_injected == 1


def test_session_rejects_journal_with_mesh_or_cold_engine():
    """A journal needs a warm-start engine (the port has no mesh yet, so the
    mesh half of the reference test waits for that slice)."""
    cold = MultitaskEngine(PROGRAM, hw=MSP430, policy=EnginePolicy(warm_start=False),
                           scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)))
    with pytest.raises(ValueError, match="warm-start"):
        ServingSession(cold, journal=Journal(MemoryJournalStore()))
    # Nothing else is refused: streaming, the scratch arm and a budget open.
    warm = MultitaskEngine(PROGRAM, hw=MSP430, policy=EnginePolicy(streaming=True))
    session = ServingSession(warm, journal=Journal(), checkpointing=False,
                             energy=EnergyBudget(1.0, 1.0))
    assert session.streaming and not session.checkpointing


# --------------------------------------------------------------------------
# Recovery: exactly-once, checkpoint resume, repeated reboots
# --------------------------------------------------------------------------

def _crash_and_recover(api, prog, reqs, script, use_checkpoints=True):
    engine = _engine(api, prog)
    store = api["store"]()
    engine.power_injector = (PowerFailureInjector if api is PORT_API else RInjector)(
        script=script)
    session = api["session"](engine, journal=api["journal"](store))
    for r in reqs:
        session.submit(r)
    with pytest.raises(api["failure"]):
        session.drain()
    mid = api["journal"](store).replay()
    engine.power_injector = None
    engine.executor.reset()
    recovered = api["session"].recover(api["journal"](store), engine,
                                       use_checkpoints=use_checkpoints)
    return engine, store, mid, recovered


def test_recover_resumes_interrupted_group_exactly_once():
    reqs, rreqs = _requests(PORT_API), _requests(REF_API)
    ref = _baseline(PORT_API, PROGRAM, reqs)
    engine, store, mid, recovered = _crash_and_recover(PORT_API, PROGRAM, reqs, {"suffix": [1]})
    _, rstore, rmid, rrecovered = _crash_and_recover(REF_API, REF, rreqs, {"suffix": [1]})
    assert mid.inflight is not None and mid.checkpoint is not None
    assert_same_journal_state(mid, rmid)
    committed_before = set(mid.responses)
    for seq in committed_before:
        fut = recovered.recovered[seq]
        assert fut.done() and fut.result().recovered
    recovered.drain()
    rrecovered.drain()
    assert recovered.stats == recovered.predicted
    _same_stats(recovered.stats, rrecovered.stats)
    final = Journal(store).replay()
    assert_same_journal_state(final, RJournal(rstore).replay())
    assert set(final.responses) == {f.seq for f in recovered.recovered.values()} \
        == set(range(len(reqs)))
    for seq, ref_out in ref.items():
        _assert_outputs_match(final.responses[seq]["outputs"], ref_out)
    commits = [r for r in store.records() if r["kind"] == "group_commit"]
    gids = [r["group_id"] for r in commits]
    assert len(gids) == len(set(gids))
    covered = [s for r in commits for s in r["seqs"]]
    assert len(covered) == len(set(covered))
    # The open group was closed in place by the resumed run.
    assert mid.inflight["group_id"] in gids
    # And it resumed mid-suffix: it skipped blocks the cold plan executes.
    assert recovered.stats.blocks_skipped > 0


def test_recover_without_checkpoints_reruns_from_scratch():
    reqs, rreqs = _requests(PORT_API), _requests(REF_API)
    ref = _baseline(PORT_API, PROGRAM, reqs)
    _, store, _mid, recovered = _crash_and_recover(
        PORT_API, PROGRAM, reqs, {"suffix": [1]}, use_checkpoints=False)
    _, rstore, _rmid, rrecovered = _crash_and_recover(
        REF_API, REF, rreqs, {"suffix": [1]}, use_checkpoints=False)
    assert recovered.checkpointing is False
    recovered.drain()
    rrecovered.drain()
    assert recovered.stats == recovered.predicted
    assert recovered.stats.checkpoint_bytes == 0.0
    _same_stats(recovered.stats, rrecovered.stats)
    final = Journal(store).replay()
    assert_same_journal_state(final, RJournal(rstore).replay())
    assert set(final.responses) == set(range(len(reqs)))
    for seq, ref_out in ref.items():
        _assert_outputs_match(final.responses[seq]["outputs"], ref_out)


def _reboot_soak(api, prog, reqs, injector):
    """Drive ``reqs`` to completion through ``injector``'s failure schedule,
    rebooting (reset + recover) after every death — recoveries themselves may
    die and are retried.  Returns (final session, store, reboots)."""
    ref = _baseline(api, prog, reqs)
    engine = _engine(api, prog)
    engine.power_injector = injector
    store = api["store"]()
    session = api["session"](engine, journal=api["journal"](store))
    for r in reqs:
        session.submit(r)
    reboots = 0
    while True:
        try:
            session.drain()
            break
        except api["failure"]:
            reboots += 1
            assert session.stats == session.predicted
            while True:
                engine.executor.reset()
                try:
                    session = api["session"].recover(api["journal"](store), engine)
                    break
                except api["failure"]:
                    reboots += 1
    assert injector.total_injected == reboots > 0
    assert session.stats == session.predicted
    final = api["journal"](store).replay()
    assert set(final.responses) == set(range(len(reqs)))
    for seq, ref_out in ref.items():
        _assert_outputs_match(final.responses[seq]["outputs"], ref_out)
    commits = [r for r in store.records() if r["kind"] == "group_commit"]
    gids = [r["group_id"] for r in commits]
    assert len(gids) == len(set(gids))
    covered = [s for r in commits for s in r["seqs"]]
    assert len(covered) == len(set(covered))
    return session, store, reboots


def _soak_both(n, seed, rates, inj_seed, max_failures):
    p = _reboot_soak(PORT_API, PROGRAM, _requests(PORT_API, n, seed),
                     PowerFailureInjector(rates=rates, seed=inj_seed, max_failures=max_failures))
    r = _reboot_soak(REF_API, REF, _requests(REF_API, n, seed),
                     RInjector(rates=rates, seed=inj_seed, max_failures=max_failures))
    assert p[2] == r[2]
    _same_stats(p[0].stats, r[0].stats)
    assert_same_journal_state(Journal(p[1]).replay(), RJournal(r[1]).replay())
    return p[2]


def test_repeated_reboots_stay_exact_and_exactly_once():
    """Chaos reboots: a seeded schedule kills the session (and its
    recoveries) many times over, the same deaths as the reference's."""
    _soak_both(10, 2, {"group": 0.4, "suffix": 0.4}, 17, 12)


@pytest.mark.slow
def test_reboot_soak_long_trace():
    """The reference's nightly soak: a longer trace under a denser failure
    schedule, dozens of reboots, exact and exactly-once end to end."""
    assert _soak_both(40, 6, {"group": 0.35, "suffix": 0.35}, 23, 40) >= 15


def test_prefetch_power_failure_recovers_a_streamed_journaled_session():
    """Streaming and the journal together: a death at the ``"prefetch"``
    site (a group begun, nothing run) recovers exactly-once, counters exact
    with the streamed loads, as in the reference."""
    runs = []
    for api, prog, injector in ((PORT_API, PROGRAM, PowerFailureInjector),
                                (REF_API, REF, RInjector)):
        reqs = [api["request"](x=api["x"](x), tasks=t)
                for x, t in zip(_xs(8, 12), [(0, 1), (2, 3), (0,), (3,)] * 2)]
        engine = api["engine"](prog, hw=api["hw"], policy=api["policy"](streaming=True),
                               scheduler=api["sched"](batch_shapes=(1, 2)))
        engine.power_injector = injector(script={"prefetch": [1], "suffix": [2]})
        store = api["store"]()
        session = api["session"](engine, journal=api["journal"](store))
        for r in reqs:
            session.submit(r)
        deaths = 0
        while True:
            try:
                session.drain()
                break
            except api["failure"]:
                deaths += 1
                engine.executor.reset()
                session = api["session"].recover(api["journal"](store), engine)
        assert deaths == 2 and session.stats == session.predicted
        runs.append((session, store))
    (s, store), (rs, rstore) = runs
    _same_stats(s.stats, rs.stats)
    assert s.stats.prefetched_bytes == rs.stats.prefetched_bytes
    assert_same_journal_state(Journal(store).replay(), RJournal(rstore).replay())
    assert set(Journal(store).replay().responses) == set(range(8))


# --------------------------------------------------------------------------
# The same LeNet-5 trace and power script in both packages
# --------------------------------------------------------------------------

LENET_GROUPS = [
    [[0, 1, 2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0], [1], [2], [3], [4]],
]


def test_lenet_journal_state_matches_reference():
    """LeNet-5 (the reference's weights carried over), a journaled session
    over 10 requests with deaths at the "group" and "suffix" sites, then
    recovery and drain: the journal states replay equal mid-way and at the
    end, and the port's file store replays equal to its memory store."""
    rgraph = RTaskGraph.from_groups(LENET_GROUPS)
    ref_prog = r_mt.build_cnn_program(jax.random.PRNGKey(0), rgraph, [4, 3, 4, 2, 4])
    tree = jax.tree_util.tree_map
    port_prog = p_mt.program_from_reference(
        TaskGraph(rgraph.num_tasks, rgraph.partitions),
        tree(np.asarray, ref_prog.node_params), tree(np.asarray, ref_prog.head_params),
        device="cpu")
    rng = np.random.default_rng(3)
    subsets = (None, (0, 1), (2,), (1, 2, 4), (4,))
    trace = [(rng.standard_normal((1, 28, 28, 1)).astype(np.float32),
              subsets[i % len(subsets)]) for i in range(10)]
    script = {"group": [3], "suffix": [2, 5]}
    states = []
    for api, prog, injector in ((PORT_API, port_prog, PowerFailureInjector),
                                (REF_API, ref_prog, RInjector)):
        engine = _engine(api, prog)
        engine.power_injector = injector(script=script)
        store = api["store"]()
        session = api["session"](engine, journal=api["journal"](store))
        for x, tasks in trace:
            session.submit(api["request"](x=api["x"](x), tasks=tasks))
        mids = []
        while True:
            try:
                session.drain()
                break
            except api["failure"]:
                mids.append(api["journal"](store).replay())
                while True:
                    engine.executor.reset()
                    try:
                        session = api["session"].recover(api["journal"](store), engine)
                        break
                    except api["failure"]:
                        mids.append(api["journal"](store).replay())
        assert engine.power_injector.total_injected == len(mids) == 3
        assert session.stats == session.predicted
        states.append((api["journal"](store).replay(), session, mids))
    (port, p_session, p_mids), (ref, r_session, r_mids) = states
    for a, b in zip(p_mids, r_mids):
        assert_same_journal_state(a, b)
    assert any(m.checkpoint is not None for m in p_mids)
    assert_same_journal_state(port, ref)
    _same_stats(p_session.stats, r_session.stats)
    assert set(port.responses) == set(range(len(trace)))


# --------------------------------------------------------------------------
# Energy budget
# --------------------------------------------------------------------------

def test_energy_budget_units():
    for cls in (EnergyBudget, REnergyBudget):
        b = cls(capacity_joules=10.0, harvest_watts=2.0, initial_joules=1.0)
        assert b.available == 1.0
        b.harvest(0.0)
        b.harvest(2.0)
        assert b.available == pytest.approx(5.0)
        assert b.seconds_until(5.0) == 0.0
        assert b.seconds_until(9.0) == pytest.approx(2.0)
        assert b.seconds_until(11.0) == float("inf")
        b.advance(10.0)
        assert b.available == pytest.approx(10.0)
        assert b.spilled_joules == pytest.approx(15.0)
        b.drain(4.0)
        assert b.available == pytest.approx(6.0)
        with pytest.raises(ValueError):
            b.drain(100.0)
        with pytest.raises(ValueError):
            b.advance(-1.0)


def test_energy_budget_duty_cycles_the_pump():
    runs = []
    for api, prog, budget_cls in ((PORT_API, PROGRAM, EnergyBudget),
                                  (REF_API, REF, REnergyBudget)):
        reqs = _requests(api)
        ref = _baseline(api, prog, reqs)
        budget = budget_cls(capacity_joules=1.0, harvest_watts=0.5, initial_joules=0.0)
        session = api["session"](_engine(api, prog), journal=api["journal"](api["store"]()),
                                 energy=budget, sleep=lambda s: None)
        futs = [session.submit(r) for r in reqs]
        session.drain()
        assert session.energy_pauses > 0
        assert session.energy_paused_seconds > 0.0
        assert session.groups_failed == 0
        assert session.stats == session.predicted
        for f in futs:
            _assert_outputs_match(f.result().outputs, ref[f.seq])
        runs.append((session, budget))
    (s, b), (rs, rb) = runs
    assert (s.energy_pauses, s.energy_paused_seconds) == \
        (rs.energy_pauses, rs.energy_paused_seconds)
    assert (b.available, b.drained_joules) == (rb.available, rb.drained_joules)
    _same_stats(s.stats, rs.stats)


def test_energy_budget_fails_infeasible_groups_isolated():
    reqs = _requests(PORT_API, 2, seed=1, tasks=(0,))
    session = ServingSession(_engine(PORT_API, PROGRAM), journal=Journal(MemoryJournalStore()),
                             energy=EnergyBudget(capacity_joules=1e-12, harvest_watts=1.0),
                             sleep=lambda s: None)
    futs = [session.submit(r) for r in reqs]
    session.drain()
    assert session.groups_failed >= 1
    for f in futs:
        assert f.done() and f.error() is not None
    assert all(r["kind"] != "group_commit" for r in session.journal.store.records())
    session.energy = EnergyBudget(capacity_joules=10.0, harvest_watts=10.0)
    ok = session.submit(_requests(PORT_API, 1, seed=9)[0])
    session.drain()
    assert ok.done() and ok.error() is None
