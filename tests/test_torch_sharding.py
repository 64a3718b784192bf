"""The port's sharding policy, spec utilities, scheduler shard multiple and
the cost model's mesh terms, re-pointed from the non-HLO tests of
``tests/test_sharding_and_hlo.py`` and held against the JAX package.

No process group is made here: the shard counts and spec fitting run on a
stand-in mesh object with ``axis_names`` and a ``shape`` mapping (the
reference's ``Mesh`` interface), and a mesh engine is built on one (it
places nothing until it dispatches).  The tests that need a world are in
``tests/test_torch_mesh_serving.py``.  The four HLO tests of
``test_sharding_and_hlo.py`` are re-pointed at ``hlo_cost.py``'s
counterpart, ``repro_torch.launch.op_cost``, in
``tests/test_torch_op_cost.py``.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.core import cost_model as r_cm
from repro.core.types import BlockCost as RBlockCost, MSP430 as R_MSP430
from repro.serving.batching import RequestGroupScheduler as RScheduler
from repro.sharding import policy as r_policy
from repro.sharding import utils as r_utils
from repro_torch.core import BlockCost, GraphCostModel, MSP430
from repro_torch.core.task_graph import TaskGraph
from repro_torch.launch import mesh as p_mesh
from repro_torch.serving import (
    EnginePolicy, MultitaskEngine, RequestGroupScheduler,
)
from repro_torch.sharding import policy as p_policy
from repro_torch.sharding.policy import (
    FSDP_TP_POLICY, P, POLICIES, TP_POLICY, _ambient_mesh, shard_act,
)
from repro_torch.sharding.utils import fit_spec, fit_specs, placements, tree_bytes
from tests.test_torch_session import PROGRAM


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# --------------------------------------------------------------------------
# Re-pointed from test_sharding_and_hlo.py
# --------------------------------------------------------------------------

def test_fit_spec_drops_nondivisible():
    mesh = _FakeMesh({"data": 16, "model": 16})
    # 1 KV head cannot shard over 16 -> replicated on that axis
    assert fit_spec((64, 1, 128), P(None, "model", None), mesh) == P(None, None, None)
    assert fit_spec((64, 48, 128), P(None, "model", None), mesh) == P(None, "model", None)


def test_fit_spec_tuple_prefix_fallback():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert fit_spec((32, 8), P(("pod", "data"), None), mesh) == P(("pod", "data"), None)
    assert fit_spec((2, 8), P(("pod", "data"), None), mesh) == P(("pod",), None)
    assert fit_spec((1, 8), P(("pod", "data"), None), mesh) == P(None, None)


def test_fit_specs_tree():
    mesh = _FakeMesh({"data": 4, "model": 4})
    shapes = {"a": torch.empty((8, 12), device="meta"), "b": (3,),
              "c": [torch.empty((4, 6), device="meta")]}
    specs = {"a": P("data", "model"), "b": P("model"), "c": [P(None, "model")]}
    out = fit_specs(shapes, specs, mesh)
    assert out == {"a": P("data", "model"), "b": P(None), "c": [P(None, None)]}


def test_tree_bytes():
    t = {"x": torch.empty((10, 10), dtype=torch.bfloat16, device="meta"),
         "y": [torch.empty((5,), dtype=torch.float32, device="meta")]}
    assert tree_bytes(t) == 10 * 10 * 2 + 5 * 4


def test_shard_act_noop_without_mesh():
    x = torch.ones((4, 4))
    assert shard_act(x, TP_POLICY, "batch", "model") is x


def test_shard_act_leaves_a_plain_tensor_under_a_mesh():
    x = torch.ones((4, 4))
    with p_mesh.set_mesh(_FakeMesh({"data": 2, "model": 2})):
        assert shard_act(x, TP_POLICY, "batch", "model") is x


def test_policy_axis_resolution():
    assert TP_POLICY.physical("batch") == ("pod", "data")
    assert TP_POLICY.physical("fsdp") is None
    assert FSDP_TP_POLICY.physical("fsdp") == "data"
    with pytest.raises(ValueError):
        TP_POLICY.physical("bogus")


def test_param_spec_convention():
    assert TP_POLICY.param_spec((8, 8)) == P(None, "model")
    assert FSDP_TP_POLICY.param_spec((8, 8)) == P("data", "model")
    assert TP_POLICY.param_spec((4, 8, 8)) == P(None, None, "model")
    assert TP_POLICY.param_spec((8,)) == P(None)
    assert FSDP_TP_POLICY.param_spec(()) == P()


def test_data_and_weight_shard_counts():
    mesh = _FakeMesh({"data": 4, "model": 2})
    assert TP_POLICY.data_shards(mesh) == 4
    assert TP_POLICY.weight_shards(mesh) == 2
    assert FSDP_TP_POLICY.data_shards(mesh) == 4
    assert FSDP_TP_POLICY.weight_shards(mesh) == 8
    pod = _FakeMesh({"pod": 2, "data": 4, "model": 2})
    assert TP_POLICY.data_shards(pod) == 8  # batch spans ("pod", "data")
    assert TP_POLICY.data_shards(None) == 1
    assert TP_POLICY.weight_shards(None) == 1


def test_ambient_mesh_propagates_accessor_failures(monkeypatch):
    """A broken mesh context surfaces; it never degrades every spec to
    replicated."""

    class Broken:
        def get(self):
            raise RuntimeError("mesh state corrupted")

    monkeypatch.setattr(p_policy, "CURRENT_MESH", Broken())
    with pytest.raises(RuntimeError, match="mesh state corrupted"):
        _ambient_mesh()
    with pytest.raises(RuntimeError, match="mesh state corrupted"):
        TP_POLICY.spec("batch")


def test_ambient_mesh_none_without_context():
    assert _ambient_mesh() is None


# --------------------------------------------------------------------------
# The port's own pieces
# --------------------------------------------------------------------------

def test_set_mesh_installs_and_restores_the_ambient_mesh():
    outer, inner = _FakeMesh({"data": 2, "model": 2}), _FakeMesh({"data": 4})
    with p_mesh.set_mesh(outer):
        assert _ambient_mesh() is outer
        assert TP_POLICY.spec("batch", None, "model") == P("data", None, "model")
        with p_mesh.set_mesh(inner):
            assert TP_POLICY.spec("batch", "model") == P("data", None)
        assert _ambient_mesh() is outer
    assert _ambient_mesh() is None
    assert TP_POLICY.spec("batch", "model") == P(None, None)


@pytest.mark.parametrize("spec,want", [
    (P(None, "model"), "(Replicate(), Shard(dim=1))"),
    (P("data", "model"), "(Shard(dim=0), Shard(dim=1))"),
    (P(("data", "model"), None), "(Shard(dim=0), Shard(dim=0))"),
    (P(None, None), "(Replicate(), Replicate())"),
])
def test_placements_one_per_mesh_dimension(spec, want):
    assert str(placements(spec, _FakeMesh({"data": 4, "model": 2}))) == want


def test_placements_refuse_a_tuple_out_of_mesh_order():
    with pytest.raises(ValueError, match="axis order"):
        placements(P(("model", "data")), _FakeMesh({"data": 4, "model": 2}))


def test_mesh_module_makes_no_process_group_at_import():
    import torch.distributed as dist

    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

def test_policies_match_the_reference():
    assert set(POLICIES) == set(r_policy.POLICIES)
    for name, pol in POLICIES.items():
        assert dataclasses.asdict(pol) == dataclasses.asdict(r_policy.POLICIES[name])


def _r_spec(spec):
    return RP(*spec)


SHAPES = [(8, 8), (3, 3, 1, 8), (3, 3, 8, 16), (784, 64), (64, 3), (1, 256, 8, 32),
          (1024, 256), (2, 8), (32, 8), (6,), ()]
MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}, {"data": 1, "model": 1},
          {"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16}]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(map(str, m.values())))
def test_fit_param_specs_match_the_reference(mesh_shape):
    """Every policy's fitted parameter spec equals the reference's, on the
    parameter shapes of the serving programs (a conv kernel's 3 rows do
    not divide over 4 data ranks, so FSDP replicates them), and so does the
    fitted batch spec."""
    mesh = _FakeMesh(mesh_shape)
    for (name, pol), shape in itertools.product(POLICIES.items(), SHAPES):
        rpol = r_policy.POLICIES[name]
        got = fit_spec(shape, pol.param_spec(shape), mesh)
        want = r_utils.fit_spec(shape, rpol.param_spec(shape), mesh)
        assert tuple(got) == tuple(want), (name, shape)
        if shape:
            batch = fit_spec(shape, P(pol.physical("batch")), mesh)
            assert tuple(batch) == tuple(
                r_utils.fit_spec(shape, RP(rpol.physical("batch")), mesh)), (name, shape)


@pytest.mark.parametrize("shapes,multiple", [
    ((1, 4), 4), ((1, 4, 16, 64), 4), ((2, 4), 2), ((1, 3, 5), 8), ((4,), 1),
])
def test_shard_multiple_matches_the_reference(shapes, multiple):
    got = RequestGroupScheduler(batch_shapes=shapes, shard_multiple=multiple)
    want = RScheduler(batch_shapes=shapes, shard_multiple=multiple)
    assert got.batch_shapes == want.batch_shapes
    assert got.shard_multiple == want.shard_multiple


def test_shard_multiple_validation():
    for bad in (0, -2):
        with pytest.raises(ValueError, match="shard multiple"):
            RequestGroupScheduler(shard_multiple=bad)


@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_mesh_engine_folds_shards_like_the_reference(policy):
    """An engine given a (4, 2) mesh pads groups to the data-shard multiple
    and divides the cost model's load terms by the weight shards, as the
    reference's does: equal batch shapes, shard counts, cost matrices and
    task order."""
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.serving import EnginePolicy as REnginePolicy
    from repro.serving import MultitaskEngine as REngine
    from tests.test_session import PROGRAM as R_PROGRAM

    if jax.device_count() < 8:
        pytest.skip("the reference's mesh needs 8 (forced host) devices")
    eng = MultitaskEngine(PROGRAM, hw=MSP430, policy=EnginePolicy(
        mesh=_FakeMesh({"data": 4, "model": 2}), sharding=POLICIES[policy],
        scheduler=RequestGroupScheduler(batch_shapes=(1, 4, 6))))
    ref = REngine(R_PROGRAM, hw=R_MSP430, policy=REnginePolicy(
        mesh=r_make_mesh((4, 2), ("data", "model")), sharding=r_policy.POLICIES[policy],
        scheduler=RScheduler(batch_shapes=(1, 4, 6))))
    assert eng.scheduler.batch_shapes == ref.scheduler.batch_shapes == (4, 8)
    assert (eng.data_shards, eng.weight_shards) == (ref.data_shards, ref.weight_shards)
    np.testing.assert_allclose(eng.cost_model.cost_matrix(), ref.cost_model.cost_matrix(),
                               rtol=1e-12)
    assert eng.order == ref.order
    assert eng.executor.collective_view(torch.zeros(4, 8)) is not None
    assert MultitaskEngine(PROGRAM, hw=MSP430).executor.collective_view(
        torch.zeros(4, 8)) is None


def test_mesh_executor_requires_the_fused_path():
    from repro_torch.core.executor import TaskGraphExecutor

    mesh = _FakeMesh({"data": 4, "model": 2})
    with pytest.raises(ValueError, match="fused"):
        TaskGraphExecutor(PROGRAM, fused=False, mesh=mesh)
    ex = TaskGraphExecutor(PROGRAM, mesh=mesh)
    assert ex.sharding is TP_POLICY
    with pytest.raises(ValueError, match="fused=False"):
        ex.fused = False


class _FixedCollectives:
    """A fixed ``CollectiveCosts``: every kind's bytes a function of the
    dispatch, all-to-all and an unknown kind included (they land in
    ``other_collective_bytes``)."""

    def breakdown(self, task, resume):
        return {"all-gather": 64.0 * (task + 1) + resume, "all-reduce": 8.0 * resume,
                "reduce-scatter": 4.0 * task, "all-to-all": 2.0, "send": 1.0}


GRAPH = TaskGraph.from_groups([[[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]]])
COSTS = [(100.0 * (d + 1), 10.0 * (d + 1)) for d in range(GRAPH.depth)]


def _models(weight_shards, metric="time"):
    from repro.core.task_graph import TaskGraph as RTaskGraph

    port = GraphCostModel(GRAPH, [BlockCost(weight_bytes=b, flops=f) for b, f in COSTS],
                          MSP430, metric=metric, weight_shards=weight_shards)
    ref = r_cm.GraphCostModel(
        RTaskGraph(GRAPH.num_tasks, GRAPH.partitions),
        [RBlockCost(weight_bytes=b, flops=f) for b, f in COSTS], R_MSP430,
        metric=metric, weight_shards=weight_shards)
    return port, ref


@pytest.mark.parametrize("order,batch", [((0, 1, 2, 3), 4), ((2, 0, 3), 1), ((3, 1), 8)])
def test_collective_terms_match_the_reference(order, batch):
    port, ref = _models(8)
    fixed = _FixedCollectives()
    resume = (None, (1, (0, 1)), None)
    got = port.predicted_stats(order, batch, resume=resume, collectives=fixed)
    want = ref.predicted_stats(order, batch, resume=resume, collectives=fixed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.collective_bytes > 0 and got.other_collective_bytes > 0
    got_e = port.expected_stats(order, batch, collectives=fixed)
    want_e = ref.expected_stats(order, batch, collectives=fixed)
    assert dataclasses.asdict(got_e) == dataclasses.asdict(want_e)
    pp, rp = port.plan_predictor(), ref.plan_predictor()
    for _ in range(2):
        pp.append(order, batch, collectives=fixed)
        rp.append(order, batch, collectives=fixed)
    assert dataclasses.asdict(pp.stats) == dataclasses.asdict(rp.stats)
    assert dataclasses.asdict(pp.expected) == dataclasses.asdict(rp.expected)


@pytest.mark.parametrize("metric", ["time", "energy"])
@pytest.mark.parametrize("weight_shards", [1, 2, 8])
def test_weight_shard_divisor_matches_the_reference(metric, weight_shards):
    port, ref = _models(weight_shards, metric)
    for d in range(GRAPH.depth):
        assert port.load_cost(d) == pytest.approx(ref.load_cost(d), rel=1e-12)
    np.testing.assert_allclose(port.cost_matrix(), ref.cost_matrix(), rtol=1e-12)
    stats = port.predicted_stats((0, 1, 2, 3), 4)
    assert stats.seconds(MSP430, weight_shards=weight_shards) == pytest.approx(
        ref.predicted_stats((0, 1, 2, 3), 4).seconds(R_MSP430, weight_shards=weight_shards),
        rel=1e-12)
    assert port.prefetch_stall_seconds([0, 1], 1e-4) == pytest.approx(
        ref.prefetch_stall_seconds([0, 1], 1e-4), rel=1e-12)
