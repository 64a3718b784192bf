"""The port's mesh-sharded request-group serving, re-pointed from
``tests/test_mesh_serving.py``, the two ``test_reliability.py::
test_mesh_fallback_*`` tests and ``test_adaptive.py::
test_adaptive_composes_with_mesh``, and held against the JAX package's
mesh engine.

The port's side runs in one world of 8 gloo ranks — a (4, 2) ("data",
"model") ``DeviceMesh``, and a (2, 4) one for the adaptive case — started
once for the whole file by a module-scoped fixture: 8 child processes,
each this file run as a script (``python tests/test_torch_mesh_serving.py
RANK DIR``), which import neither JAX nor the JAX package, set one thread,
join through a ``FileStore`` under the test's temporary directory, run
every scenario of :data:`SCENARIOS` in lockstep, save their results with
``np.save`` and destroy their process group.  The fixture waits at most
:data:`WORLD_SECONDS` for the world and fails the tests if it runs over;
no process group is ever made in the pytest process (the last test checks
that, and that no child is left).  Each test then asserts on its
scenario's results, and on the reference's, which runs in the pytest
process on the 8 forced host devices of ``tests/conftest.py``.

The contract under test:

* sharding is invisible to results — outputs allclose (``rtol=atol=1e-5``)
  to the reference's mesh engine and to the port's one-device engine;
* counters are exact — ``session.stats == session.predicted`` field for
  field, collective fields included, with ``collective_bytes > 0``; every
  non-collective field equals the reference's;
* the collective bytes are measured, not modelled — re-running each
  dispatched suffix (``TaskGraphExecutor.suffix_trace``) under
  ``torch.profiler`` and summing each collective's result bytes reproduces
  the session's per-kind counters exactly, and ``CommDebugMode`` counts the
  same collectives as the recorder.  Per-kind bytes are *not* held against
  XLA's: DTensor and XLA's partitioner may pick different collectives for
  one layout (``test_dim8_breakdown_side_by_side`` prints both);
* the ladder's ``"single_device"`` rung serves a group that fails on the
  mesh off it, with exact counters and no collective bytes.

The four HLO tests of ``tests/test_sharding_and_hlo.py`` have no
counterpart until the FLOP counter that replaces ``hlo_cost.py`` is ported
(ROADMAP item 11).
"""
import dataclasses
import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
WORLD_SECONDS = 180
DIM = 8
TOL = dict(rtol=1e-5, atol=1e-5)
GRAPH_GROUPS = [[[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]]]
GRAPH6_GROUPS = [
    [[0, 1, 2, 3, 4, 5]],
    [[0, 1, 2], [3, 4, 5]],
    [[0, 1], [2], [3], [4, 5]],
    [[0], [1], [2], [3], [4], [5]],
]
TF_GROUPS = [[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]]]
TF_SEQ = 12
TF_SUBSETS = [None, (0, 1), (2,), None]
SUBSET_CHOICES = (None, (0,), (1, 2), (0, 3), (2, 1), (0, 1, 2, 3))
POLICIES = ("tp", "fsdp_tp")
COLLECTIVE_FIELDS = ("all_gather_bytes", "all_reduce_bytes",
                     "reduce_scatter_bytes", "other_collective_bytes")
KIND_FIELDS = {"all-gather": "all_gather_bytes", "all-reduce": "all_reduce_bytes",
               "reduce-scatter": "reduce_scatter_bytes"}


def _randomized_cases():
    """The reference's randomized fallback draws (``default_rng(7)``)."""
    rng = np.random.default_rng(7)
    cases = []
    for trial in range(2):
        n = int(rng.integers(1, 7))
        subsets = [SUBSET_CHOICES[i] for i in rng.integers(0, len(SUBSET_CHOICES), n)]
        cases.append((subsets, 100 + trial))
    return cases


#: (subsets, seed) of every round trip: the reference's fixed case, its two
#: randomized-fallback trials, and three fixed examples standing in for its
#: hypothesis property (``max_examples=3``).
ROUNDTRIPS = {
    "fixed": ([None, (0,), (1, 2), (0, 3), (2, 1), None, (1, 2), None], 0),
    **{f"random{i}": c for i, c in enumerate(_randomized_cases())},
    "property0": ([(0, 3)], 1),
    "property1": ([None, (2, 1), (0,), (1, 2), None], 4242),
    "property2": ([(0, 1, 2, 3), (0,), (0,), (2, 1), (0, 3), None], 65535),
}


# ==========================================================================
# The port's side: one rank of the world (no JAX, no reference package)
# ==========================================================================

def _block(p, x):
    return torch.tanh(x @ p)


def _head(p, x):
    return x @ p


def _toy_program(groups, seed=0):
    """The reference tests' ``tanh(x @ W)`` program, its weights drawn by
    ``np.random.default_rng(seed)`` in the reference's order."""
    from repro_torch.core import BlockCost, MultitaskProgram
    from repro_torch.core.task_graph import TaskGraph

    graph = TaskGraph.from_groups(groups)
    rng = np.random.default_rng(seed)
    costs = [BlockCost(weight_bytes=100.0 * (d + 1), flops=10.0 * (d + 1))
             for d in range(graph.depth)]
    nodes = {node: torch.tensor(rng.normal(size=(DIM, DIM)), dtype=torch.float32)
             for node in graph.nodes()}
    heads = [torch.tensor(rng.normal(size=(DIM, 3)), dtype=torch.float32)
             for _ in range(graph.num_tasks)]
    return MultitaskProgram(graph, [_block] * graph.depth, nodes,
                            [_head] * graph.num_tasks, heads, costs)


def _requests(rng, subsets):
    from repro_torch.serving import MultitaskRequest

    return [MultitaskRequest(
        x=torch.tensor(rng.normal(size=(DIM,)), dtype=torch.float32), tasks=s)
        for s in subsets]


def _adaptive_inputs(rng, n):
    scale = np.where(np.arange(n) % 3 == 0, 0.2, 2.0)[:, None]
    return (rng.normal(size=(n, DIM)) * scale).astype(np.float32)


def _stats(s):
    return dataclasses.asdict(s)


def _outputs(responses):
    return [{t: o.detach().cpu().numpy() for t, o in r.outputs.items()} for r in responses]


def _policy(name):
    from repro_torch.sharding.policy import POLICIES as P_POLICIES

    return P_POLICIES[name]


def _engine(program, mesh=None, sharding=None, shapes=(1, 4), **kw):
    from repro_torch.core import MSP430
    from repro_torch.serving import EnginePolicy, MultitaskEngine, RequestGroupScheduler

    policy = kw.pop("policy", EnginePolicy())
    policy = dataclasses.replace(
        policy, mesh=mesh, sharding=sharding,
        scheduler=RequestGroupScheduler(batch_shapes=shapes))
    return MultitaskEngine(program, hw=MSP430, policy=policy, **kw)


_DTYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
                "int": 4, "long int": 8, "bool": 1}


def _profiled_collective_bytes(run):
    """Per-kind result bytes of the collectives ``run()`` issues, read off
    ``torch.profiler`` events (recorded shapes, dtypes and group sizes) —
    no code shared with the executor's recorder."""
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True
    ) as prof:
        run()
    totals = {}
    for e in prof.events():
        if not e.name.startswith("_c10d_functional::"):
            continue
        op = e.name.split("::")[1]
        if op in ("wait_tensor", "_wrap_tensor_autograd"):
            continue
        n_in = int(np.prod(e.input_shapes[0])) * _DTYPE_BYTES[e.input_dtypes[0]]
        if op.startswith("all_gather"):
            kind, nbytes = "all-gather", n_in * e.concrete_inputs[1]
        elif op.startswith("reduce_scatter"):
            kind, nbytes = "reduce-scatter", n_in // e.concrete_inputs[2]
        elif op.startswith("all_reduce"):
            kind, nbytes = "all-reduce", n_in
        else:
            kind, nbytes = "other", n_in
        totals[kind] = totals.get(kind, 0) + nbytes
    return totals


def _comm_debug_counts(run):
    """Per-kind collective counts of ``run()`` under ``CommDebugMode``."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as cdm:
        run()
    counts = {}
    for op, n in cdm.get_comm_counts().items():
        name = str(op)
        kind = next((k for key, k in (("all_gather", "all-gather"),
                                      ("reduce_scatter", "reduce-scatter"),
                                      ("all_reduce", "all-reduce"),
                                      ("all_to_all", "all-to-all")) if key in name), "other")
        counts[kind] = counts.get(kind, 0) + n
    return counts


def _recorder_counts(run):
    from repro_torch.sharding.collectives import CollectiveRecorder

    with CollectiveRecorder() as rec:
        run()
    return dict(rec.counts)


def _dispatches(engine, groups):
    """``(group, task, resume)`` of every suffix dispatch of a plan: a
    group's first task runs its whole path, each later one resumes at its
    shared prefix with its predecessor."""
    out = []
    for g in groups:
        prev = None
        for t in engine.group_order(g):
            shared = (engine.program.graph.shared_prefix_depth(prev, t)
                      if prev is not None else 0)
            out.append((g, t, shared))
            prev = t
    return out


def _w_roundtrip(ctx, subsets, seed):
    program = ctx["dim8"]
    rng = np.random.default_rng(seed)
    reqs = _requests(rng, subsets)
    out = {}
    for name in POLICIES:
        eng = _engine(program, ctx["mesh"], _policy(name))
        groups = eng.plan_groups(reqs)
        measured, dispatches, cdm, rec = {}, [], {}, {}
        for g, t, shared in _dispatches(eng, groups):
            run = lambda: eng.executor.suffix_trace(t, shared, g.xs)  # noqa: E731
            for k, v in _profiled_collective_bytes(run).items():
                measured[k] = measured.get(k, 0) + v
            for store, counts in ((cdm, _comm_debug_counts(run)),
                                  (rec, _recorder_counts(run))):
                for k, v in counts.items():
                    store[k] = store.get(k, 0) + v
            dispatches.append(
                (t, shared, eng.executor.collective_view(g.xs).breakdown(t, shared)))
        session = eng.session()
        futures = [session.submit(r) for r in reqs]
        session.drain()
        out[name] = {
            "shards_divide": all(s % eng.data_shards == 0 for s in eng.scheduler.batch_shapes),
            "stats": _stats(session.stats), "predicted": _stats(session.predicted),
            "profiled": measured, "cdm_counts": cdm, "recorder_counts": rec,
            "dispatches": dispatches, "outputs": _outputs([f.result() for f in futures]),
        }
    return out


def _w_single_request(ctx):
    from repro_torch.serving import MultitaskRequest

    program = ctx["dim8"]
    x = torch.tensor(np.random.default_rng(3).normal(size=(DIM,)), dtype=torch.float32)
    a = _engine(program, ctx["mesh"], _policy("tp")).serve(MultitaskRequest(x=x))
    b = _engine(program).serve(MultitaskRequest(x=x))
    return {"mesh": _outputs([a]), "solo": _outputs([b])}


def _w_fallback(ctx, subsets, seed, max_faults):
    from repro_torch.serving import FaultInjector, RetryPolicy

    program = ctx["dim8"]
    reqs = _requests(np.random.default_rng(seed), subsets)
    inj = FaultInjector(rates={"dispatch": 1.0}, max_faults=max_faults, seed=9)
    eng = _engine(program, ctx["mesh"], _policy("tp"), fault_injector=inj)
    session = eng.session(retry=RetryPolicy(max_retries=1, degrade=True))
    pre = eng.executor.residency_state()
    out = {}
    f0 = session.submit(reqs[0])
    session.drain()
    err = f0.error()
    if err is None:
        r0 = f0.result()
        out["first"] = {"degraded": r0.degraded, "retries": r0.retries,
                        "outputs": _outputs([r0])[0]}
    else:
        out["first"] = {"error": type(err).__name__,
                        "cause": type(err.__cause__).__name__}
    out["after_first"] = {
        "degraded_runs": session.degraded_runs, "groups_failed": session.groups_failed,
        "exact": session.stats == session.predicted,
        "collective_bytes": session.stats.collective_bytes,
        "rolled_back": eng.executor.residency_state() == pre,
    }
    f1 = session.submit(reqs[1])
    session.drain()
    r1 = f1.result()
    out["second"] = {"degraded": r1.degraded, "outputs": _outputs([r1])[0],
                     "exact": session.stats == session.predicted,
                     "collective_bytes": session.stats.collective_bytes}
    out["solo"] = _outputs(_engine(program).serve_batch(
        [dataclasses.replace(r) for r in reqs]))
    return out


def _w_adaptive(ctx):
    from repro_torch.adaptive import AdaptivePolicy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import EnginePolicy, MultitaskRequest

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    program = _toy_program(GRAPH6_GROUPS)
    rng = np.random.default_rng(10)
    xs = _adaptive_inputs(rng, 4)
    reqs = [MultitaskRequest(x=torch.tensor(x), tasks=s)
            for x, s in zip(xs, [None, (0, 1), (2, 3, 4), None])]
    policy = EnginePolicy(adaptive=AdaptivePolicy(threshold=0.5))
    out = {}
    for label, m in (("mesh", mesh), ("solo", None)):
        eng = _engine(program, m, None, shapes=(2, 4), policy=policy)
        session = eng.session()
        futures = [session.submit(r) for r in reqs]
        session.drain()
        out[label] = {"stats": _stats(session.stats), "predicted": _stats(session.predicted),
                      "outputs": _outputs([f.result() for f in futures])}
    return out


def _w_transformer(ctx):
    import repro_torch.kernels.ops as ops
    from repro_torch import configs as p_configs
    from repro_torch.core.task_graph import TaskGraph
    from repro_torch.models import multitask as p_mt
    from repro_torch.serving import MultitaskRequest

    cfg = dataclasses.replace(p_configs.get_smoke_config("mistral-nemo-12b"), num_layers=2)
    nodes, heads = ctx["inputs"]["transformer"]
    program = p_mt.transformer_program_from_reference(
        TaskGraph.from_groups(TF_GROUPS), cfg, nodes, heads, TF_SEQ, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 1000, (len(TF_SUBSETS), 1, TF_SEQ)).astype(np.int32)
    reqs = [MultitaskRequest(x=torch.tensor(tk), tasks=s) for tk, s in zip(tokens, TF_SUBSETS)]
    local_shapes = set()
    plain = ops.flash_attention_bhsd_ref

    def recording(q, k, v, **kw):
        local_shapes.add((q.shape[0], q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    out = {}
    try:
        for name in POLICIES:
            eng = _engine(program, ctx["mesh"], _policy(name), shapes=(4,))
            # Shape probes and calibration runs first: the recorded flash
            # calls are then the session's own.
            eng.predicted_group_stats(eng.plan_groups(reqs))
            local_shapes.clear()
            ops.flash_attention_bhsd_ref = recording
            session = eng.session()
            futures = [session.submit(r) for r in reqs]
            session.drain()
            ops.flash_attention_bhsd_ref = plain
            out[name] = {"stats": _stats(session.stats), "predicted": _stats(session.predicted),
                         "outputs": _outputs([f.result() for f in futures]),
                         "flash_local_shapes": sorted(local_shapes)}
    finally:
        ops.flash_attention_bhsd_ref = plain
    return out


def _w_placement(ctx):
    program = ctx["dim8"]
    out = {}
    for name in POLICIES:
        ex = _engine(program, ctx["mesh"], _policy(name)).executor
        xs = torch.tensor(np.random.default_rng(5).normal(size=(4, DIM)), dtype=torch.float32)

        def run():
            for node in program.graph.nodes():
                ex._placed_node.pop(node, None)
                ex._node_param(node)
            for t in range(program.graph.num_tasks):
                ex._placed_head.pop(t, None)
                ex._head_param(t)
            ex._commit(xs, batched=True)

        out[name] = {"cdm": _comm_debug_counts(run), "recorder": _recorder_counts(run),
                     "param_placements": [str(tuple(p.placements))
                                          for p in ex._placed_node.values()]}
    return out


def _w_journal(ctx):
    from repro_torch.serving.journal import Journal, MemoryJournalStore

    eng = _engine(ctx["dim8"], ctx["mesh"], _policy("tp"))
    try:
        eng.session(journal=Journal(MemoryJournalStore()))
    except ValueError as err:
        return {"raised": str(err)}
    return {"raised": None}


def _w_make_mesh_mismatch(ctx):
    from repro_torch.launch.mesh import make_mesh

    try:
        make_mesh((2, 2), ("data", "model"), device="cpu")
    except ValueError as err:
        return {"raised": str(err)}
    return {"raised": None}


SCENARIOS = {
    **{f"roundtrip_{k}": (lambda ctx, c=c: _w_roundtrip(ctx, *c)) for k, c in ROUNDTRIPS.items()},
    "single_request": _w_single_request,
    "fallback_rung": lambda ctx: _w_fallback(ctx, [None, (1, 2)], 31, 2),
    "fallback_fails": lambda ctx: _w_fallback(ctx, [None, (0, 3)], 32, 3),
    "adaptive": _w_adaptive,
    "transformer": _w_transformer,
    "placement": _w_placement,
    "journal": _w_journal,
    "make_mesh_mismatch": _w_make_mesh_mismatch,
}


def _child_main(rank: int, workdir: Path) -> None:
    """One rank: join the world, run every scenario in lockstep, save."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(workdir / "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        with open(workdir / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        ctx = {"inputs": inputs, "dim8": _toy_program(GRAPH_GROUPS),
               "mesh": make_mesh((4, 2), ("data", "model"), device="cpu")}
        results = {}
        for name, fn in SCENARIOS.items():
            t0 = time.perf_counter()
            try:
                results[name] = fn(ctx)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
            print(f"rank {rank} {name} {time.perf_counter() - t0:.2f}s", flush=True)
        results["forbidden_imports"] = sorted(
            m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        np.save(workdir / f"rank{rank}.npy", np.array(results, dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


# ==========================================================================
# The pytest side: the world, the reference, the checks
# ==========================================================================

_CHILDREN = []


def _reference_transformer():
    """The reference's 2-layer smoke mistral-nemo program, fp32."""
    import jax
    from repro import configs as r_configs
    from repro.core import task_graph as r_tg
    from repro.models import multitask as r_mt

    cfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"), num_layers=2)
    return r_mt.build_transformer_program(
        jax.random.PRNGKey(0), r_tg.TaskGraph.from_groups(TF_GROUPS), cfg, [4, 3, 5], TF_SEQ)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_transformer():
    return _reference_transformer()


@pytest.fixture(scope="module")
def world(tmp_path_factory, ref_transformer):
    """Run the 8-rank world once; returns each rank's results."""
    workdir = tmp_path_factory.mktemp("mesh_world")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"transformer": (_np_tree(ref_transformer.node_params),
                                     _np_tree(ref_transformer.head_params))}, f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PYTHONDONTWRITEBYTECODE": "1"}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(workdir)],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    _CHILDREN.extend(procs)
    deadline = time.monotonic() + WORLD_SECONDS
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        overran = [p for p in procs if p.poll() is None]
        for p in overran:
            p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tail = (workdir / "rank0.log").read_text()[-4000:]
    if overran:
        pytest.fail(f"the world ran over {WORLD_SECONDS} s; rank 0's log:\n{tail}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"ranks {bad} failed; rank {bad[0]}'s log:\n"
                    + (workdir / f"rank{bad[0]}.log").read_text()[-4000:])
    return [np.load(workdir / f"rank{r}.npy", allow_pickle=True).item() for r in range(WORLD)]


def _scenario(world, name):
    res = world[0][name]
    if "error" in res:
        pytest.fail(f"scenario {name} failed in the world:\n{res['error']}")
    return res


def _assert_outputs_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for t in b:
            np.testing.assert_allclose(a[t], np.asarray(b[t]), **tol)


def _non_collective(stats):
    d = stats if isinstance(stats, dict) else dataclasses.asdict(stats)
    return {k: v for k, v in d.items() if k not in COLLECTIVE_FIELDS}


# ------------------------------------------------------ the reference side

def _ref_mesh_engine(program, policy_name, shapes=(1, 4), mesh_shape=(4, 2), **kw):
    from repro.core import MSP430 as R_MSP430
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.serving import EnginePolicy as REnginePolicy
    from repro.serving import MultitaskEngine as REngine
    from repro.serving import RequestGroupScheduler as RScheduler
    from repro.sharding import policy as r_policy

    sharding = None if policy_name is None else r_policy.POLICIES[policy_name]
    policy = kw.pop("policy", REnginePolicy())
    policy = dataclasses.replace(
        policy, mesh=r_make_mesh(mesh_shape, ("data", "model")), sharding=sharding,
        scheduler=RScheduler(batch_shapes=shapes))
    return REngine(program, hw=R_MSP430, policy=policy, **kw)


def _ref_session(engine, reqs):
    session = engine.session()
    futures = [session.submit(r) for r in reqs]
    session.drain()
    return session, [{t: np.asarray(o) for t, o in f.result().outputs.items()}
                     for f in futures]


def _ref_requests(rng, subsets):
    import jax.numpy as jnp
    from repro.serving import MultitaskRequest as RRequest

    return [RRequest(x=jnp.asarray(rng.normal(size=(DIM,)), jnp.float32), tasks=s)
            for s in subsets]


@pytest.fixture(scope="module")
def ref_roundtrips():
    """The reference's mesh sessions of every round trip, per policy:
    ``(session.stats, outputs)`` and, for the fixed case, each dispatch's
    HLO breakdown."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("the reference's mesh needs 8 (forced host) devices")
    from repro.launch.hlo_cost import collective_breakdown
    from tests.test_mesh_serving import PROGRAM as R_PROGRAM

    out = {}
    for key, (subsets, seed) in ROUNDTRIPS.items():
        for name in POLICIES:
            eng = _ref_mesh_engine(R_PROGRAM, name)
            reqs = _ref_requests(np.random.default_rng(seed), subsets)
            dispatches = []
            if key == "fixed":
                for g, t, shared in _dispatches(eng, eng.plan_groups(reqs)):
                    dispatches.append((t, shared, collective_breakdown(
                        eng.executor.suffix_hlo(t, shared, g.xs))))
            session, outputs = _ref_session(eng, reqs)
            out[key, name] = (session.stats, outputs, dispatches)
    return out


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(ROUNDTRIPS))
def test_mesh_serving_roundtrip(world, ref_roundtrips, case, policy):
    """``test_mesh_serving.py``'s ``_check_roundtrip`` on the fixed case, the
    randomized-fallback trials and the property's examples: padded widths
    split over the data axis, counters exact with collectives, per-kind
    bytes equal to the profiler's re-measurement and ``CommDebugMode``'s
    counts equal to the recorder's, outputs and non-collective counters
    equal to the reference's mesh engine."""
    res = _scenario(world, f"roundtrip_{case}")[policy]
    assert res["shards_divide"]
    for rank in range(WORLD):  # collective bytes are this rank's own
        mine = world[rank][f"roundtrip_{case}"][policy]
        stats = mine["stats"]
        assert stats == mine["predicted"]
        assert sum(stats[k] for k in COLLECTIVE_FIELDS) > 0
        for kind, field in KIND_FIELDS.items():
            assert stats[field] == mine["profiled"].get(kind, 0), (rank, kind)
        assert stats["other_collective_bytes"] == mine["profiled"].get("other", 0)
        assert mine["cdm_counts"] == mine["recorder_counts"]
    stats = res["stats"]
    r_stats, r_outputs, _ = ref_roundtrips[case, policy]
    assert _non_collective(stats) == _non_collective(r_stats)
    _assert_outputs_close(res["outputs"], r_outputs)


def test_dim8_breakdown_side_by_side(world, ref_roundtrips):
    """The fixed case's per-dispatch collective bytes on both sides, printed
    (run with ``-s``): the dispatches are the same; the collectives need not
    be (ROADMAP quirks)."""
    for policy in POLICIES:
        port = _scenario(world, "roundtrip_fixed")[policy]["dispatches"]
        ref = ref_roundtrips["fixed", policy][2]
        assert [(t, r) for t, r, _ in port] == [(t, r) for t, r, _ in ref]
        print(f"\n{policy}: task resume | port (DTensor, gloo) | reference (XLA HLO)")
        for (t, r, pb), (_t, _r, rb) in zip(port, ref):
            print(f"  {t} {r} | {dict(sorted(pb.items()))} | "
                  f"{dict(sorted((k, v) for k, v in rb.items() if v))}")
        assert sum(sum(b.values()) for _t, _r, b in port) > 0


def test_single_request_on_mesh(world):
    res = _scenario(world, "single_request")
    _assert_outputs_close(res["mesh"], res["solo"])


def _ref_fallback(subsets, seed, max_faults):
    from repro.serving import FaultInjector as RInjector
    from repro.serving import RetryPolicy as RRetry
    from tests.test_session import PROGRAM as R_PROGRAM

    reqs = _ref_requests(np.random.default_rng(seed), subsets)
    eng = _ref_mesh_engine(R_PROGRAM, "tp", fault_injector=RInjector(
        rates={"dispatch": 1.0}, max_faults=max_faults, seed=9))
    session = eng.session(retry=RRetry(max_retries=1, degrade=True))
    f0 = session.submit(reqs[0])
    session.drain()
    f1 = session.submit(reqs[1])
    session.drain()
    return session, f0, f1


def test_mesh_fallback_rung_serves_group_on_single_device(world):
    """Two sharded attempts fault at dispatch; the ``single_device`` rung
    serves the group cold off the mesh: outputs equal the fault-free serve,
    counters exact with no collective bytes, the primary executor rolled
    back, and the next group runs on the mesh again — as in the reference."""
    res = _scenario(world, "fallback_rung")
    first, after = res["first"], res["after_first"]
    assert first["degraded"] == "single_device" and first["retries"] == 2
    _assert_outputs_close([first["outputs"]], res["solo"][:1])
    assert after == {"degraded_runs": 1, "groups_failed": 0, "exact": True,
                     "collective_bytes": 0.0, "rolled_back": True}
    second = res["second"]
    assert second["degraded"] is None and second["exact"]
    assert second["collective_bytes"] > 0
    _assert_outputs_close([second["outputs"]], res["solo"][1:])
    r_session, r_f0, r_f1 = _ref_fallback([None, (1, 2)], 31, 2)
    assert r_f0.result().degraded == first["degraded"]
    assert r_f0.result().retries == first["retries"]
    assert r_f1.result().degraded == second["degraded"]


def test_mesh_fallback_failure_rolls_back_and_keeps_serving(world):
    """The fallback rung itself fails: the residency snapshot is restored,
    the members fail cleanly, and the session serves the next group on the
    mesh with exact counters."""
    res = _scenario(world, "fallback_fails")
    assert res["first"] == {"error": "RequestError", "cause": "InjectedFault"}
    assert res["after_first"] == {"degraded_runs": 0, "groups_failed": 1, "exact": True,
                                  "collective_bytes": 0.0, "rolled_back": True}
    second = res["second"]
    assert second["degraded"] is None and second["exact"]
    assert second["collective_bytes"] > 0
    _assert_outputs_close([second["outputs"]], res["solo"][1:])
    r_session, r_f0, _r_f1 = _ref_fallback([None, (0, 3)], 32, 3)
    assert r_f0.error() is not None and r_session.groups_failed == 1


def test_adaptive_composes_with_mesh(world):
    """An adaptive engine on a (2, 4) mesh: counters exact with collectives,
    outputs equal the one-device adaptive engine's and the reference's mesh
    engine's, non-collective counters equal the reference's."""
    import jax.numpy as jnp
    from repro.serving import EnginePolicy as REnginePolicy
    from repro.serving import MultitaskRequest as RRequest
    from repro.adaptive import AdaptivePolicy as RAdaptive
    from tests.test_adaptive import PROGRAM as R_PROGRAM6

    res = _scenario(world, "adaptive")
    mesh, solo = res["mesh"], res["solo"]
    assert mesh["stats"] == mesh["predicted"]
    assert mesh["stats"]["all_gather_bytes"] + mesh["stats"]["all_reduce_bytes"] > 0
    _assert_outputs_close(mesh["outputs"], solo["outputs"], dict(rtol=1e-5, atol=1e-6))
    xs = _adaptive_inputs(np.random.default_rng(10), 4)
    reqs = [RRequest(x=jnp.asarray(x), tasks=s)
            for x, s in zip(xs, [None, (0, 1), (2, 3, 4), None])]
    eng = _ref_mesh_engine(R_PROGRAM6, None, shapes=(2, 4), mesh_shape=(2, 4),
                           policy=REnginePolicy(adaptive=RAdaptive(threshold=0.5)))
    r_session, r_outputs = _ref_session(eng, reqs)
    assert _non_collective(mesh["stats"]) == _non_collective(r_session.stats)
    _assert_outputs_close(mesh["outputs"], r_outputs)


@pytest.fixture(scope="module")
def ref_transformer_sessions(ref_transformer):
    import jax

    if jax.device_count() < 8:
        pytest.skip("the reference's mesh needs 8 (forced host) devices")
    tokens = np.random.default_rng(3).integers(0, 1000, (len(TF_SUBSETS), 1, TF_SEQ)).astype(np.int32)
    from repro.serving import MultitaskRequest as RRequest

    reqs = [RRequest(x=jax.numpy.asarray(tk), tasks=s) for tk, s in zip(tokens, TF_SUBSETS)]
    return {name: _ref_session(_ref_mesh_engine(ref_transformer, name, shapes=(4,)), reqs)
            for name in POLICIES}


@pytest.mark.parametrize("policy", POLICIES)
def test_smoke_transformer_on_mesh(world, ref_transformer_sessions, policy):
    """A 2-layer smoke mistral-nemo program on the (4, 2) mesh: flash runs
    through ``local_map`` on each rank's 1 batch row and 4 of the 8 query
    heads (1 of the 2 KV heads); counters exact with collectives; outputs
    and non-collective counters equal the reference's mesh engine's."""
    res = _scenario(world, "transformer")[policy]
    assert res["flash_local_shapes"] == [(1, 4, 1)]
    assert res["stats"] == res["predicted"]
    assert sum(res["stats"][k] for k in COLLECTIVE_FIELDS) > 0
    r_session, r_outputs = ref_transformer_sessions[policy]
    assert _non_collective(res["stats"]) == _non_collective(r_session.stats)
    _assert_outputs_close(res["outputs"], r_outputs)


def test_placing_params_and_inputs_issues_no_collective(world):
    """Every rank places its own slice of the full tensors it built from the
    seed: no collective, by ``CommDebugMode`` and by the recorder.  Under
    FSDP the (8, 8) matrices shard over both axes, under TP over
    ``model`` only."""
    res = _scenario(world, "placement")
    for name in POLICIES:
        assert res[name]["cdm"] == {} and res[name]["recorder"] == {}
    assert set(res["tp"]["param_placements"]) == {"(Replicate(), Shard(dim=1))"}
    assert set(res["fsdp_tp"]["param_placements"]) == {"(Shard(dim=0), Shard(dim=1))"}


def test_journaled_session_on_mesh_engine_raises(world):
    assert "mesh-sharded engines" in (_scenario(world, "journal")["raised"] or "")


def test_make_mesh_refuses_a_world_of_another_size(world):
    assert "needs a world of 4 ranks" in (_scenario(world, "make_mesh_mismatch")["raised"] or "")


def test_ranks_agree(world):
    """Every rank served the same trace in lockstep: the same full outputs,
    the same counters but for the collective bytes, and the same number of
    collectives of each kind.  The bytes are each rank's own result bytes,
    which differ where DTensor splits a dimension unevenly (ROADMAP
    quirks: the 3 classes of a head over the 2 ``model`` ranks)."""
    for rank in range(1, WORLD):
        for name in SCENARIOS:
            a, b = world[0][name], world[rank][name]
            assert _rank_invariant(a) == _rank_invariant(b), (rank, name)


def _rank_invariant(tree):
    """``tree`` without its collective bytes, each array as its bytes."""
    if isinstance(tree, dict):
        return {k: _rank_invariant(v) for k, v in tree.items()
                if k not in COLLECTIVE_FIELDS + ("profiled", "dispatches", "collective_bytes")}
    if isinstance(tree, (list, tuple)):
        return [_rank_invariant(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree.tobytes()
    return tree


def test_children_import_neither_jax_nor_the_reference(world):
    assert all(rank["forbidden_imports"] == [] for rank in world)


def test_zz_no_process_group_in_pytest_and_no_child_left():
    """Runs last in this file: the world lived in its children only."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert all(p.poll() is not None for p in _CHILDREN)


if __name__ == "__main__":
    _child_main(int(sys.argv[1]), Path(sys.argv[2]))
