"""The port's input-adaptive serving (``repro_torch.adaptive``, the gated
executor, expected counters, the session's deadline ladder), re-pointed from
``tests/test_adaptive.py`` and held against the JAX package.

Re-pointed contracts, on the port alone: masked gating in fused suffixes
gives the per-block reference's outputs and counters, the counters replay
the realized gate trace field for field, ``threshold=inf`` is the
all-blocks floor, the two gate modes coincide on scan suffixes, expected
counters equal the exact enumeration of gate outcomes, and gating composes
with warm starts, segmented checkpoints and restored checkpoints.  (The
reference's mesh composition and its full-size benchmark wait for the
slices that port the mesh and the benchmarks.)

Against the reference, on the same numpy-seeded inputs and the reference's
weights carried over: in fp32 the ``TaskGateRecord`` traces are identical,
``ExecutionStats`` field-exact and outputs allclose at 1e-5 — for a direct
executor (scan and unrolled suffixes, fused and per-block), a one-shot
``serve_batch`` and a calibrated session, whose ``expected`` agrees to
rel 1e-9.  In bf16 the two packages' GEMMs differ in their last bits, so a
row whose reference confidence lies within 2**-7 (relative) of the
threshold at some gated block may decide differently; every other row's
fire decisions must be identical.

Hypothesis runs derandomized (``derandomize=True, database=None``).
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import adaptive as r_ad
from repro import configs as r_configs
from repro.core import executor as r_ex
from repro.core import task_graph as r_tg
from repro.core.types import (
    BlockCost as RBlockCost, ExecutionStats as RExecutionStats, TPU_V5E as R_TPU,
)
from repro.models import multitask as r_mt
from repro.serving import engine as r_engine
from repro.serving import policies as r_pol
from repro.serving import session as r_session
from repro.serving.batching import RequestGroupScheduler as RScheduler
from repro_torch import adaptive as p_ad
from repro_torch import configs as p_configs
from repro_torch.adaptive import (
    ALWAYS_FIRE, AdaptivePolicy, BlockGater, GateModel, GateModelCalibrator,
    mean_abs_confidence,
)
from repro_torch.core import (
    BlockCost, GraphCostModel, MSP430, MultitaskProgram, TPU_V5E,
)
from repro_torch.core.executor import TaskGraphExecutor
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import ExecutionStats, TaskGateRecord
from repro_torch.models import multitask as p_mt
from repro_torch.serving import (
    EnginePolicy, MultitaskEngine, MultitaskRequest, RequestGroupScheduler,
)
from repro_torch.serving import engine as p_engine
from repro_torch.serving import policies as p_pol
from repro_torch.serving import session as p_session

DIM = 8
GROUPS6 = [
    [[0, 1, 2, 3, 4, 5]],
    [[0, 1, 2], [3, 4, 5]],
    [[0, 1], [2], [3], [4, 5]],
    [[0], [1], [2], [3], [4], [5]],
]
GRAPH6 = TaskGraph.from_groups(GROUPS6)
TOL = dict(rtol=1e-5, atol=1e-6)
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: a row whose reference confidence is within this relative distance of
# the threshold at some gated block may fire differently in the two packages.
BF16_MARGIN = 2.0 ** -7


def _block(p, x):
    return torch.tanh(x @ p)


def _head(p, x):
    return x @ p


def _weights(graph, seed):
    """The reference tests' weights, drawn by ``np.random.default_rng(seed)``
    in the reference's order (nodes, then heads)."""
    rng = np.random.default_rng(seed)
    nodes = {node: rng.normal(size=(DIM, DIM)).astype(np.float32)
             for node in graph.nodes()}
    heads = [rng.normal(size=(DIM, 3)).astype(np.float32)
             for _ in range(graph.num_tasks)]
    return nodes, heads


def _costs(graph):
    return [(100.0 * (d + 1), 10.0 * (d + 1)) for d in range(graph.depth)]


def _program(graph=GRAPH6, seed=0, unrolled=False):
    """The port's toy program: ``tanh(x @ W)`` blocks, linear heads.  One
    block fn for every depth drives each suffix as a scan; ``unrolled``
    gives each depth its own fn object, which makes every suffix unrolled."""
    nodes, heads = _weights(graph, seed)
    fns = ([(lambda p, x: torch.tanh(x @ p)) for _ in range(graph.depth)]
           if unrolled else [_block] * graph.depth)
    return MultitaskProgram(
        graph, fns, {n: torch.tensor(w) for n, w in nodes.items()},
        [_head] * graph.num_tasks, [torch.tensor(h) for h in heads],
        [BlockCost(weight_bytes=b, flops=f) for b, f in _costs(graph)],
    )


def _ref_program(graph=GRAPH6, seed=0, unrolled=False):
    """The same program in the JAX package."""
    nodes, heads = _weights(graph, seed)
    rgraph = r_tg.TaskGraph(graph.num_tasks, graph.partitions)

    def block(p, x):
        return jnp.tanh(x @ p)

    fns = ([(lambda p, x: jnp.tanh(x @ p)) for _ in range(graph.depth)]
           if unrolled else [block] * graph.depth)
    return r_ex.MultitaskProgram(
        rgraph, fns, {n: jnp.asarray(w) for n, w in nodes.items()},
        [lambda p, x: x @ p] * graph.num_tasks, [jnp.asarray(h) for h in heads],
        [RBlockCost(weight_bytes=b, flops=f) for b, f in _costs(graph)],
    )


PROGRAM = _program()


def _inputs_np(rng, n):
    """Mixed-difficulty rows: small-norm rows stay under the confidence
    threshold (keep firing); large-norm tanh activations exit early."""
    scale = np.where(np.arange(n) % 3 == 0, 0.2, 2.0)[:, None]
    return (rng.normal(size=(n, DIM)) * scale).astype(np.float32)


def _inputs(rng, n):
    return torch.tensor(_inputs_np(rng, n))


def _gater(**kw):
    kw.setdefault("threshold", 0.5)
    return BlockGater(**kw)


def _outputs_allclose(a, b, tol=TOL):
    assert set(a) == set(b)
    for t in a:
        np.testing.assert_allclose(
            np.asarray(a[t], np.float32), np.asarray(b[t], np.float32), **tol)


def _asdict(stats):
    return dataclasses.asdict(stats)


# --------------------------------------------------------------------------
# Re-pointed: executor, fused == per-block, counters == trace replay
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["early_exit", "per_block"])
def test_adaptive_fused_matches_per_block_reference(mode):
    rng = np.random.default_rng(0)
    xs = _inputs(rng, 6)
    order = list(range(GRAPH6.num_tasks))

    fused = TaskGraphExecutor(PROGRAM, gater=_gater(mode=mode))
    ref = TaskGraphExecutor(PROGRAM, fused=False, gater=_gater(mode=mode))

    of, sf = fused.run_batch(xs, order)
    orf, sr = ref.run_batch(xs, order)
    _outputs_allclose(of, orf)
    assert sf == sr
    assert fused.last_trace == ref.last_trace
    assert sf.block_rows_gated > 0  # the stream actually exercised gating
    assert sf.flops_gated > 0


def test_early_exit_equals_per_block_on_scan_suffixes():
    rng = np.random.default_rng(1)
    xs = _inputs(rng, 5)
    order = [0, 3, 1, 4, 2, 5]
    ee = TaskGraphExecutor(PROGRAM, gater=_gater(mode="early_exit"))
    pb = TaskGraphExecutor(PROGRAM, gater=_gater(mode="per_block"))
    oe, se = ee.run_batch(xs, order)
    ob, sb = pb.run_batch(xs, order)
    _outputs_allclose(oe, ob)
    assert se == sb
    assert ee.last_trace == pb.last_trace


def test_executor_stats_equal_trace_replay():
    rng = np.random.default_rng(2)
    xs = _inputs(rng, 4)
    order = [2, 0, 5, 3, 1, 4]
    ex = TaskGraphExecutor(PROGRAM, gater=_gater())
    _, stats = ex.run_batch(xs, order)
    cm = GraphCostModel(GRAPH6, PROGRAM.block_costs, MSP430)
    predicted = cm.predicted_stats(
        order, batch_size=4, gate_trace=ex.last_trace)
    assert stats == predicted
    # One fire-mask readback per gated task.
    assert ex.gate_readbacks == len(order)


def test_inf_threshold_is_all_blocks_floor():
    rng = np.random.default_rng(3)
    xs = _inputs(rng, 4)
    order = list(range(GRAPH6.num_tasks))
    gated = TaskGraphExecutor(PROGRAM, gater=_gater(threshold=ALWAYS_FIRE))
    plain = TaskGraphExecutor(PROGRAM)
    og, sg = gated.run_batch(xs, order)
    op, sp = plain.run_batch(xs, order)
    for t in op:  # masking with an all-true mask changes no bit
        assert torch.equal(og[t], op[t])
    assert sg.flops_gated == 0
    assert sg.block_rows_gated == 0
    assert sg.flops_executed == sp.flops_executed
    assert sg.weight_bytes_loaded == sp.weight_bytes_loaded


def test_min_blocks_floor_is_respected():
    rng = np.random.default_rng(4)
    xs = _inputs(rng, 4)
    ex = TaskGraphExecutor(PROGRAM, gater=_gater(threshold=0.0, min_blocks=2))
    ex.run_batch(xs, [0, 1, 2, 3, 4, 5])
    for rec in ex.last_trace:
        for i, fired in enumerate(rec.fired):
            depth = rec.resume + i
            if depth < 2:
                assert fired == rec.weight
            else:
                assert fired == 0


def test_threshold_change_refills_one_device_tensor():
    """Thresholds are a runtime input: serving three thresholds in a row
    builds no new suffix program, and each ``(start, stop)`` keeps one
    threshold tensor, refilled in place, on the activation's device."""
    rng = np.random.default_rng(12)
    xs = _inputs(rng, 4)
    order = list(range(GRAPH6.num_tasks))
    ex = TaskGraphExecutor(PROGRAM, gater=_gater(threshold=0.5))
    ex.run_batch(xs, order)
    programs = len(ex._compiled_fused)
    tensors = {k: id(t) for k, (_v, t) in ex._thresholds.items()}
    for thr in (0.3, 0.8, ALWAYS_FIRE):
        ex.gater.threshold = thr
        _, stats = ex.run_batch(xs, order)
        assert len(ex._compiled_fused) == programs
        assert {k: id(t) for k, (_v, t) in ex._thresholds.items()} == tensors
        for (start, stop, device), (values, t) in ex._thresholds.items():
            assert device == xs.device and t.device == xs.device
            assert t.dtype == torch.float32
            assert values == ex.gater.suffix_thresholds(start, stop)
            assert torch.equal(t, torch.tensor(values, dtype=torch.float32))
    assert stats.block_rows_gated == 0


def test_mean_abs_confidence_rounds_like_the_reference():
    """A bf16 row's confidence accumulates in fp32 and is rounded to bf16,
    as ``jnp.mean(jnp.abs(h))`` does: the bf16 confidences are equal; in
    fp32 the two sums' orders differ in the last bit."""
    rng = np.random.default_rng(13)
    rows = rng.normal(size=(16, 3, 40)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        h = torch.tensor(rows).to(dtype)
        got = torch.vmap(mean_abs_confidence)(h)
        assert got.dtype == dtype
        want = jax.vmap(r_ad.mean_abs_confidence)(
            jnp.asarray(h.float().numpy()).astype(jdtype))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-6 if dtype == torch.float32 else 0, atol=0)


# --------------------------------------------------------------------------
# Re-pointed: expected counters == exact enumeration of gate outcomes
# --------------------------------------------------------------------------

TINY = TaskGraph.from_groups([[[0, 1]], [[0], [1]]])
TINY_COSTS = [BlockCost(weight_bytes=64.0, flops=16.0),
              BlockCost(weight_bytes=32.0, flops=8.0)]


def check_expected_equals_enumeration(qs, order=(0, 1)):
    """Expected counters == sum_w P(w) * realized-trace prediction, where w
    ranges over the full product of per-(task, depth) Bernoulli outcomes
    (per-block gating, batch 1, every task runs)."""
    cm = GraphCostModel(TINY, TINY_COSTS, MSP430)
    gm = GateModel(fire={
        (t, d): qs[(t, d)] for t in range(2) for d in range(2)
    })
    slots = []
    prev = None
    resumes = {}
    for t in order:
        shared = 0 if prev is None else TINY.shared_prefix_depth(prev, t)
        resumes[t] = shared
        slots.extend((t, d) for d in range(shared, TINY.depth))
        prev = t
    expected = cm.expected_stats(order, batch_size=1, gate_model=gm)
    acc = {f.name: 0.0 for f in dataclasses.fields(ExecutionStats)}
    for bits in itertools.product((0, 1), repeat=len(slots)):
        p = 1.0
        fired = {t: [] for t in order}
        for (t, d), bit in zip(slots, bits):
            q = qs[(t, d)]
            p *= q if bit else (1.0 - q)
            fired[t].append(bit)
        trace = [
            TaskGateRecord(task=t, weight=1, fired=tuple(fired[t]),
                           resume=resumes[t])
            for t in order
        ]
        stats = cm.predicted_stats(order, batch_size=1, gate_trace=trace)
        for f in dataclasses.fields(ExecutionStats):
            acc[f.name] += p * getattr(stats, f.name)
    for f in dataclasses.fields(ExecutionStats):
        assert getattr(expected, f.name) == pytest.approx(
            acc[f.name], rel=1e-9, abs=1e-9), f.name


def test_expected_equals_enumeration_fixed_seeds():
    rng = np.random.default_rng(5)
    for trial in range(6):
        qs = {(t, d): float(rng.uniform(0.0, 1.0))
              for t in range(2) for d in range(2)}
        check_expected_equals_enumeration(qs, order=(0, 1) if trial % 2
                                          else (1, 0))
    check_expected_equals_enumeration(
        {(t, d): 1.0 for t in range(2) for d in range(2)})
    check_expected_equals_enumeration(
        {(t, d): 0.0 for t in range(2) for d in range(2)})


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(
    qs=st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=4,
                max_size=4),
    flip=st.booleans(),
)
def test_expected_equals_enumeration_hypothesis(qs, flip):
    table = {(t, d): qs[2 * t + d] for t in range(2) for d in range(2)}
    check_expected_equals_enumeration(
        table, order=(1, 0) if flip else (0, 1))


def test_calibrated_expected_matches_measured_mean():
    rng = np.random.default_rng(6)
    xs = _inputs(rng, 8)
    order = list(range(GRAPH6.num_tasks))
    ex = TaskGraphExecutor(PROGRAM, gater=_gater())
    _, stats = ex.run_batch(xs, order)
    cal = GateModelCalibrator()
    cal.observe(ex.last_trace)
    cm = GraphCostModel(GRAPH6, PROGRAM.block_costs, MSP430,
                        gate_model=cal.model())
    expected = cm.expected_stats(order, batch_size=8)
    assert expected.flops_executed == pytest.approx(stats.flops_executed)
    assert expected.block_rows_fired == pytest.approx(stats.block_rows_fired)
    assert expected.block_rows_gated == pytest.approx(stats.block_rows_gated)


# --------------------------------------------------------------------------
# Re-pointed: composition with the rest of the stack
# --------------------------------------------------------------------------

def _adaptive_engine(**engine_kw):
    policy = engine_kw.pop("policy", EnginePolicy())
    policy = dataclasses.replace(
        policy, adaptive=AdaptivePolicy(threshold=0.5))
    return MultitaskEngine(PROGRAM, hw=MSP430, policy=policy, **engine_kw)


def test_adaptive_composes_with_warm_start():
    rng = np.random.default_rng(7)
    reqs = [MultitaskRequest(x=x, tasks=s)
            for x, s in zip(_inputs(rng, 6), [None, (0, 1), (4, 5),
                                              None, (2, 3), (0, 5)])]
    warm = _adaptive_engine()
    cold = _adaptive_engine(policy=EnginePolicy(warm_start=False))
    sw = warm.session()
    fw = [sw.submit(r) for r in reqs]
    sw.drain()
    sc = cold.session()
    fc = [sc.submit(r) for r in reqs]
    sc.drain()
    assert sw.stats == sw.predicted
    assert sc.stats == sc.predicted
    for a, b in zip(fw, fc):
        _outputs_allclose(a.result().outputs, b.result().outputs)
    assert sw.stats.weight_bytes_loaded <= sc.stats.weight_bytes_loaded


def test_adaptive_composes_with_segmented_checkpoints():
    rng = np.random.default_rng(8)
    xs = _inputs(rng, 4)
    one = TaskGraphExecutor(PROGRAM, gater=_gater())
    seg = TaskGraphExecutor(PROGRAM, gater=_gater())
    s1, s2 = ExecutionStats(), ExecutionStats()
    hook_depths = []
    out1 = one.run_task_batch(0, xs, s1)
    out2 = seg.run_task_batch(
        0, xs, s2, checkpoint_depths=[1, 2],
        checkpoint_hook=hook_depths.append,
    )
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), **TOL)
    assert hook_depths == [1, 2]
    assert one.last_gate_record == seg.last_gate_record
    assert s1 == s2


def test_adaptive_composes_with_restored_checkpoint():
    rng = np.random.default_rng(9)
    x = _inputs(rng, 4)
    full = TaskGraphExecutor(PROGRAM, gater=_gater())
    out_full = full.run_task_batch(0, x, ExecutionStats())
    rec_full = full.last_gate_record

    seg = TaskGraphExecutor(PROGRAM, gater=_gater())
    cks = []
    seg.run_task_batch(
        0, x, ExecutionStats(), checkpoint_depths=[2],
        checkpoint_hook=lambda _d: cks.append(seg.activation_checkpoint(0)),
    )
    ck = cks[0]
    assert ck is not None and 0 < ck.depth + 1 < GRAPH6.depth

    resumed = TaskGraphExecutor(PROGRAM, gater=_gater())
    resumed.restore_activation(ck)
    stats = ExecutionStats()
    out_res = resumed.run_task_batch(0, x, stats)
    np.testing.assert_allclose(out_full.numpy(), out_res.numpy(), **TOL)
    rec = resumed.last_gate_record
    assert rec.resume == ck.depth + 1
    assert rec.fired == rec_full.fired[rec.resume - rec_full.resume:]
    cm = GraphCostModel(GRAPH6, PROGRAM.block_costs, MSP430)
    predicted = cm.predicted_stats(
        [0], batch_size=4, gate_trace=[rec],
        first_task_resume=rec.resume)
    assert stats == predicted


def test_gate_deps_enable_resolve_for_gated_engines():
    def gate(outputs):
        return bool(np.asarray(outputs[0])[0] > 0) if 0 in outputs else True

    eng = MultitaskEngine(
        PROGRAM, hw=MSP430, gates={3: gate}, gate_deps={3: (0,)},
        policy=EnginePolicy(resolve_order_per_plan=True),
    )
    rng = np.random.default_rng(11)
    reqs = [MultitaskRequest(x=x, tasks=s)
            for x, s in zip(_inputs(rng, 4), [None, (0, 3), (0, 3, 4), None])]
    groups = eng.plan_groups(reqs)
    assert any(g.order is not None for g in groups)
    for g in groups:
        order = eng.group_order(g)
        if 0 in order and 3 in order:
            assert order.index(0) < order.index(3)
    sess = eng.session()
    futs = [sess.submit(r) for r in reqs]
    sess.drain()
    assert sess.stats == sess.predicted
    for f in futs:
        assert f.result().outputs


# --------------------------------------------------------------------------
# Against the JAX package: the synthetic six-task program (fp32)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_block"])
@pytest.mark.parametrize("mode", ["early_exit", "per_block"])
@pytest.mark.parametrize("unrolled", [False, True], ids=["scan", "unrolled"])
def test_executor_matches_reference(unrolled, mode, fused):
    rng = np.random.default_rng(20)
    xs = _inputs_np(rng, 6)
    order = [0, 3, 1, 4, 2, 5]
    ref = r_ex.TaskGraphExecutor(
        _ref_program(unrolled=unrolled), fused=fused,
        gater=r_ad.BlockGater(mode=mode, threshold=0.5))
    port = TaskGraphExecutor(
        _program(unrolled=unrolled), fused=fused, gater=_gater(mode=mode))
    r_out, r_stats = ref.run_batch(jnp.asarray(xs), order, valid=5)
    p_out, p_stats = port.run_batch(torch.tensor(xs), order, valid=5)
    if fused:
        modes = {m for _f, m in port._compiled_fused.values()}
        assert modes == {"unrolled"} if unrolled else "scan" in modes
    assert port.last_trace == [TaskGateRecord(**dataclasses.asdict(r))
                               for r in ref.last_trace]
    assert _asdict(p_stats) == _asdict(r_stats)
    assert p_stats.block_rows_gated > 0 and p_stats.block_rows_fired > 0
    _outputs_allclose(p_out, r_out, PARITY_TOL)


def test_segmented_and_restored_match_reference():
    """A checkpointed (segmented) task and a resume from its restored
    checkpoint give the reference's records, counters and outputs."""
    rng = np.random.default_rng(21)
    xs = _inputs_np(rng, 4)
    results = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            ex = r_ex.TaskGraphExecutor(_ref_program(), gater=r_ad.BlockGater(threshold=0.5))
            x, new = jnp.asarray(xs), lambda: r_ex.TaskGraphExecutor(
                _ref_program(), gater=r_ad.BlockGater(threshold=0.5))
            stats_cls = type(r_ex.ExecutionStats())
        else:
            ex = TaskGraphExecutor(PROGRAM, gater=_gater())
            x, new = torch.tensor(xs), lambda: TaskGraphExecutor(PROGRAM, gater=_gater())
            stats_cls = ExecutionStats
        cks, s1 = [], stats_cls()
        out1 = ex.run_task_batch(
            1, x, s1, checkpoint_depths=[1],
            checkpoint_hook=lambda _d: cks.append(ex.activation_checkpoint(1)))
        rec1 = ex.last_gate_record
        resumed = new()
        resumed.restore_activation(cks[0])
        s2 = stats_cls()
        out2 = resumed.run_task_batch(1, x, s2)
        results.append((np.asarray(out1, np.float32), np.asarray(out2, np.float32),
                        dataclasses.asdict(rec1), dataclasses.asdict(resumed.last_gate_record),
                        _asdict(s1), _asdict(s2)))
    (r1, r2, *r_rest), (p1, p2, *p_rest) = results
    assert p_rest == r_rest
    np.testing.assert_allclose(p1, r1, **PARITY_TOL)
    np.testing.assert_allclose(p2, r2, **PARITY_TOL)


# --------------------------------------------------------------------------
# Against the JAX package: engines and sessions
# --------------------------------------------------------------------------

TF_GRAPH = r_tg.TaskGraph.from_groups([[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]]])
TF_SEQ = 12
SUBSETS = (None, (0, 1), (2,), (1, 2), (0,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _transformer_programs(dtype="float32"):
    """Both packages' 2-layer smoke mistral-nemo programs in ``dtype``, the
    reference's weights carried over."""
    rcfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"),
                               num_layers=2, dtype=dtype, param_dtype=dtype)
    pcfg = dataclasses.replace(p_configs.get_smoke_config("mistral-nemo-12b"),
                               num_layers=2, dtype=dtype, param_dtype=dtype)
    ref = r_mt.build_transformer_program(jax.random.PRNGKey(0), TF_GRAPH, rcfg, [4, 3, 5], TF_SEQ)
    port = p_mt.transformer_program_from_reference(
        TaskGraph(TF_GRAPH.num_tasks, TF_GRAPH.partitions), pcfg,
        _np_tree(ref.node_params), _np_tree(ref.head_params), TF_SEQ, device="cpu",
    )
    return ref, port


@pytest.fixture(scope="module")
def tf_fp32():
    return _transformer_programs("float32")


def _tokens(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1000, (n, 1, TF_SEQ)).astype(np.int32)


def _median_confidence(program, tokens):
    """The median, over the requests, of the block-1 input confidence in an
    ungated pass (the threshold the gated runs use)."""
    x = torch.tensor(tokens)
    h = program.block_fns[0](program.node_params[program.graph.path(0)[0]], x.flatten(0, 1))
    conf = torch.vmap(mean_abs_confidence)(h.unflatten(0, x.shape[:2])).float()
    return float(conf.median())


@pytest.mark.parametrize("mode", ["early_exit", "per_block"])
def test_transformer_executor_matches_reference(tf_fp32, mode):
    ref_prog, port_prog = tf_fp32
    tokens = _tokens(4)
    thr = _median_confidence(port_prog, tokens)
    order = [0, 2, 1]
    ref = r_ex.TaskGraphExecutor(ref_prog, gater=r_ad.BlockGater(mode=mode, threshold=thr))
    port = TaskGraphExecutor(port_prog, gater=BlockGater(mode=mode, threshold=thr))
    r_out, r_stats = ref.run_batch(jnp.asarray(tokens), order)
    p_out, p_stats = port.run_batch(torch.tensor(tokens), order)
    assert port.last_trace == [TaskGateRecord(**dataclasses.asdict(r))
                               for r in ref.last_trace]
    assert _asdict(p_stats) == _asdict(r_stats)
    assert p_stats.block_rows_gated > 0 and p_stats.block_rows_fired > 0
    _outputs_allclose(p_out, r_out, PARITY_TOL)


def _engine_pair(ref_prog, port_prog, r_hw, p_hw, threshold, **adaptive_kw):
    return (
        r_engine.MultitaskEngine(
            ref_prog, hw=r_hw, scheduler=RScheduler(batch_shapes=(1, 2, 4)),
            policy=r_pol.EnginePolicy(adaptive=r_ad.AdaptivePolicy(
                threshold=threshold, **adaptive_kw))),
        MultitaskEngine(
            port_prog, hw=p_hw, scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)),
            policy=EnginePolicy(adaptive=AdaptivePolicy(threshold=threshold, **adaptive_kw))),
    )


def _check_responses(port_resps, ref_resps):
    for p, r in zip(port_resps, ref_resps):
        assert (p.effective_order, p.group_size) == (r.effective_order, r.group_size)
        assert _asdict(p.stats) == _asdict(r.stats)
        _outputs_allclose(p.outputs, r.outputs, PARITY_TOL)


@pytest.mark.parametrize("program", ["toy", "transformer"])
def test_serve_batch_matches_reference(tf_fp32, program):
    if program == "toy":
        rng = np.random.default_rng(22)
        xs = list(_inputs_np(rng, 9))
        engines = _engine_pair(_ref_program(), PROGRAM, R_TPU, TPU_V5E, 0.5)
        subsets = [None, (0, 1), (4, 5), None, (2, 3), (0, 5), (0, 1), None, (2, 3)]
    else:
        tokens = _tokens(7, seed=4)
        xs = list(tokens)
        engines = _engine_pair(*tf_fp32, R_TPU, TPU_V5E,
                               _median_confidence(tf_fp32[1], tokens))
        subsets = [SUBSETS[i % len(SUBSETS)] for i in range(len(xs))]
    ref, port = engines
    r_resps = ref.serve_batch([r_engine.MultitaskRequest(x=jnp.asarray(x), tasks=s)
                               for x, s in zip(xs, subsets)])
    p_resps = port.serve_batch([MultitaskRequest(x=torch.tensor(x), tasks=s)
                                for x, s in zip(xs, subsets)])
    _check_responses(p_resps, r_resps)
    assert _asdict(port.last_batch_stats) == _asdict(ref.last_batch_stats)
    assert port.last_batch_stats.block_rows_gated > 0


@pytest.mark.parametrize("program", ["toy", "transformer"])
def test_calibrated_session_matches_reference(tf_fp32, program):
    """A session with online calibration: responses, counters, prediction and
    the a-priori ``expected`` agree with the reference's; calibration then
    re-predicts a re-served trace's flops."""
    if program == "toy":
        rng = np.random.default_rng(23)
        xs = list(_inputs_np(rng, 8))
        ref, port = _engine_pair(_ref_program(), PROGRAM, R_TPU, TPU_V5E, 0.5,
                                 calibrate_online=True)
    else:
        tokens = _tokens(6, seed=5)
        xs = list(tokens)
        ref, port = _engine_pair(*tf_fp32, R_TPU, TPU_V5E,
                                 _median_confidence(tf_fp32[1], tokens),
                                 calibrate_online=True)
    subsets = [SUBSETS[i % len(SUBSETS)] for i in range(len(xs))]
    sessions, planned = [], []
    for eng, pol, req_cls, conv in (
            (ref, r_pol, r_engine.MultitaskRequest, jnp.asarray),
            (port, p_pol, MultitaskRequest, torch.tensor)):
        runs = []
        for _ in range(2):  # serve, then re-serve: the calibrated model predicts it
            sess = eng.session(policy=pol.WindowPolicy(max_wait=0.0, max_group_size=4))
            futs = [sess.submit(req_cls(x=conv(x), tasks=s)) for x, s in zip(xs, subsets)]
            sess.drain()
            runs.append((sess, [f.result() for f in futs]))
        sessions.append((runs[0][0], runs[0][1], runs[1][0]))
        groups = eng.plan_groups([req_cls(x=conv(x), tasks=s) for x, s in zip(xs, subsets)])
        planned.append(eng.expected_group_stats(groups))
    (r_sess, r_resps, r_again), (p_sess, p_resps, p_again) = sessions
    _check_responses(p_resps, r_resps)
    assert _asdict(p_sess.stats) == _asdict(r_sess.stats)
    assert p_sess.stats == p_sess.predicted
    assert p_sess.stats.block_rows_gated > 0
    for a, b in ((p_sess.expected, r_sess.expected), (p_again.expected, r_again.expected),
                 (planned[1], planned[0])):
        for name, value in _asdict(b).items():
            assert getattr(a, name) == pytest.approx(value, rel=1e-9, abs=1e-9), name
    assert _asdict(port.cost_model.gate_model) == _asdict(ref.cost_model.gate_model)
    assert p_again.expected.flops_executed == pytest.approx(
        p_again.stats.flops_executed, rel=0.05)


# --------------------------------------------------------------------------
# Against the JAX package: bf16 smoke transformer
# --------------------------------------------------------------------------

def test_bf16_transformer_traces_match_reference_off_the_threshold():
    """bf16: the packages' GEMMs differ in their last bits, so a row whose
    reference confidence lies within ``BF16_MARGIN`` (relative) of the
    threshold at a gated block may fire differently.  Every other row's
    fire decisions — at every block of every task — are identical."""
    ref_prog, port_prog = _transformer_programs("bfloat16")
    tokens = _tokens(8, seed=6)
    thr = _median_confidence(port_prog, tokens)
    order = [0, 2, 1]
    ref = r_ex.TaskGraphExecutor(ref_prog, gater=r_ad.BlockGater(threshold=thr))
    port = TaskGraphExecutor(port_prog, gater=BlockGater(threshold=thr))
    r_conf = jax.jit(jax.vmap(r_ad.mean_abs_confidence))
    xr, xp = jnp.asarray(tokens), torch.tensor(tokens)
    r_stats, p_stats = RExecutionStats(), ExecutionStats()
    near = np.zeros(len(tokens), bool)
    masks = []
    for t in order:
        ref.run_task_batch(t, xr, r_stats)
        r_masks = np.concatenate([np.asarray(f) for _s, f in ref._fired_frags])
        port.run_task_batch(t, xp, p_stats)
        p_masks = torch.cat([f for _s, f in port._fired_frags]).numpy()
        resume = ref.last_gate_record.resume
        assert port.last_gate_record.resume == resume
        for i, d in enumerate(range(resume, TF_GRAPH.depth)):
            if d == 0:
                continue  # the embedding block changes shape: always fires
            conf = np.asarray(r_conf(ref._activations[d - 1]), np.float32)
            near |= np.abs(conf - thr) <= BF16_MARGIN * abs(thr)
        masks.append((r_masks, p_masks))
    far = ~near
    assert far.sum() >= len(tokens) // 2, f"only {far.sum()} rows off the threshold"
    gated = 0
    for r_masks, p_masks in masks:
        assert r_masks.shape == p_masks.shape
        np.testing.assert_array_equal(p_masks[:, far], r_masks[:, far])
        gated += int((~r_masks[:, far]).sum())
    assert gated > 0  # the compared rows include gated ones


# --------------------------------------------------------------------------
# The deadline ladder
# --------------------------------------------------------------------------

LADDER = ((0.5, 0.4), (2.0, 0.2), (5.0, 0.05))


@pytest.mark.parametrize("slack", [None, -1.0, 0.0, 0.5, 1.0, 2.0, 4.99, 5.0, 100.0])
def test_threshold_for_slack_matches_reference(slack):
    for ladder in (LADDER, tuple(reversed(LADDER)), ()):
        p = AdaptivePolicy(threshold=0.7, ladder=ladder).threshold_for_slack(slack)
        r = r_ad.AdaptivePolicy(threshold=0.7, ladder=ladder).threshold_for_slack(slack)
        assert p == r


def test_ladder_threshold_matches_reference():
    """The group's worst slack picks its rung; a deadline-free group takes
    the base threshold; a non-adaptive engine returns ``None``."""
    now = 10.0
    deadlines = [None, 10.3, 12.5, 16.0, 11.0]
    groups = [(0,), (0, 3), (2, 3), (1, 3, 4), (3,), (1, 2, 3, 4)]
    got = {}
    for pkg, eng_mod, ses_mod, pol, ad, prog in (
            ("ref", r_engine, r_session, r_pol, r_ad, _ref_program()),
            ("port", p_engine, p_session, p_pol, p_ad, PROGRAM)):
        out = []
        for adaptive in (ad.AdaptivePolicy(threshold=0.7, ladder=LADDER), None):
            eng = eng_mod.MultitaskEngine(
                prog, policy=pol.EnginePolicy(adaptive=adaptive))
            sess = eng.session()
            members = [
                ses_mod.PendingRequest(
                    seq=i, request=eng_mod.MultitaskRequest(x=None, deadline=d),
                    arrival=0.0, future=None)
                for i, d in enumerate(deadlines)
            ]
            out.append([sess._ladder_threshold(tuple(members[i] for i in g), now)
                        for g in groups])
        got[pkg] = out
    assert got["port"] == got["ref"]
    # Worst slacks: none, 6, 2.5, 0.3, 6, 0.3 seconds.
    assert got["port"][0] == [0.7, 0.05, 0.2, 0.7, 0.05, 0.7]
    assert got["port"][1] == [None] * len(groups)


def test_ladder_session_matches_reference():
    """A session on a laddered engine, with deadlines on a simulated clock and
    scripted faults (a retried group, a group on the unfused rung): every
    attempt runs at its group's rung in both packages, so responses,
    counters and ``expected`` agree."""
    from repro.serving import reliability as r_rel
    from repro_torch.serving import reliability as p_rel

    rng = np.random.default_rng(24)
    xs = list(_inputs_np(rng, 10))
    subsets = [SUBSETS[i % len(SUBSETS)] for i in range(len(xs))]
    # Every third request has a deadline 0.3 or 0.6 s after its arrival.
    deadlines = [None if i % 3 else 0.1 * (i + 1) + (0.6 if i % 2 else 0.3)
                 for i in range(len(xs))]
    ladder = ((0.0, 0.45), (0.3, 0.3))
    results = []
    for pkg, eng_mod, pol, rel, ad, prog, conv in (
            ("ref", r_engine, r_pol, r_rel, r_ad, _ref_program(), jnp.asarray),
            ("port", p_engine, p_pol, p_rel, p_ad, PROGRAM, torch.tensor)):
        eng = eng_mod.MultitaskEngine(
            prog, hw=R_TPU if pkg == "ref" else TPU_V5E,
            scheduler=(RScheduler if pkg == "ref" else RequestGroupScheduler)(
                batch_shapes=(1, 2, 4)),
            policy=pol.EnginePolicy(adaptive=ad.AdaptivePolicy(threshold=0.5, ladder=ladder)),
            fault_injector=rel.FaultInjector(script={"plan": {1, 2}, "dispatch": {5}}))
        asked = []
        execute = eng._execute_group
        eng._execute_group = lambda g, *a, **kw: (
            asked.append(kw.get("adaptive_threshold")), execute(g, *a, **kw))[1]
        now = [0.0]
        sess = eng.session(policy=pol.WindowPolicy(max_wait=0.15, max_group_size=3),
                           clock=lambda: now[0], sleep=lambda s: None,
                           retry=rel.RetryPolicy(max_retries=1))
        futs = []
        for x, s, d in zip(xs, subsets, deadlines):
            now[0] += 0.1
            futs.append(sess.submit(eng_mod.MultitaskRequest(x=conv(x), tasks=s, deadline=d)))
            sess.step()
        sess.drain()
        results.append((sess, [f.result() for f in futs], asked))
    (r_sess, r_resps, r_asked), (p_sess, p_resps, p_asked) = results
    assert p_asked == r_asked and {0.5, 0.45, 0.3} <= set(p_asked), p_asked
    assert any(r.degraded == "unfused" for r in p_resps)
    for p, r in zip(p_resps, r_resps):
        assert (p.retries, p.degraded) == (r.retries, r.degraded)
    _check_responses(p_resps, r_resps)
    assert _asdict(p_sess.stats) == _asdict(r_sess.stats)
    assert p_sess.stats == p_sess.predicted and p_sess.stats.block_rows_gated > 0
    assert _asdict(p_sess.expected) == pytest.approx(_asdict(r_sess.expected), rel=1e-9)
