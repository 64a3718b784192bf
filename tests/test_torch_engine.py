"""The port's ``MultitaskEngine.serve_batch`` against the JAX package's.

The same LeNet program (the reference's weights carried over), requests,
gates and engine policy go through both engines.  Counters are equal
exactly — the reference engine's ``last_batch_stats``, each response's
group stats, and the port's own ``predicted_group_stats`` of the plan made
before serving; so are each response's ``effective_order``, ``group_size``,
``order`` and modelled seconds.  Outputs agree to 1e-5 (fp32).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import task_graph as r_tg
from repro.core.constraints import Constraints as RConstraints
from repro.core.types import MSP430 as R_MSP430
from repro.models import multitask as r_mt
from repro.serving import engine as r_engine
from repro.serving.policies import EnginePolicy as REnginePolicy
from repro_torch.core import task_graph as p_tg
from repro_torch.core.constraints import Constraints as PConstraints
from repro_torch.core.types import MSP430 as P_MSP430
from repro_torch.models import multitask as p_mt
from repro_torch.serving import engine as p_engine
from repro_torch.serving.batching import RequestGroupScheduler
from repro_torch.serving.policies import EnginePolicy as PEnginePolicy

TOL = dict(rtol=1e-5, atol=1e-5)
GRAPH = r_tg.TaskGraph.from_groups([
    [[0, 1, 2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0, 1], [2, 3], [4]],
    [[0], [1], [2], [3], [4]],
])
SUBSETS = (None, (0, 1), (2, 3, 4), (1, 3), (4,), (0, 1, 2, 3, 4))


def _programs():
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(0), GRAPH, [4, 3, 4, 2, 4])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    port = p_mt.program_from_reference(
        p_tg.TaskGraph(GRAPH.num_tasks, GRAPH.partitions),
        np_tree(ref.node_params), np_tree(ref.head_params), device="cpu",
    )
    return ref, port


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, 1, 28, 28, 1)).astype(np.float32)
    picks = rng.integers(0, len(SUBSETS), size=n)
    return [(xs[i], SUBSETS[p]) for i, p in enumerate(picks)]


def _gate_on_task0(outputs):
    """Task 4 runs only for rows whose task-0 logit 0 beats logit 1."""
    if 0 not in outputs:
        return True
    y = np.asarray(outputs[0])
    return bool(y[0, 0] > y[0, 1])


VARIANTS = {
    "warm": dict(kwargs={}, policy={}),
    "cold_small_shapes": dict(
        kwargs={"warm_start": False},
        policy={"scheduler": (1, 2, 8)},
    ),
    "gated_resolved": dict(
        kwargs={"gates": {4: _gate_on_task0}, "gate_deps": {4: (0,)}},
        policy={"resolve_order_per_plan": True},
        conditional=[(0, 4, 0.5)],
    ),
}


def _engines(variant):
    spec = VARIANTS[variant]
    ref_prog, port_prog = _programs()
    engines = []
    for module, prog, msp, policy_cls, cons_cls in (
        (r_engine, ref_prog, R_MSP430, REnginePolicy, RConstraints),
        (p_engine, port_prog, P_MSP430, PEnginePolicy, PConstraints),
    ):
        policy = dict(spec["policy"])
        if "scheduler" in policy:
            policy["scheduler"] = type_scheduler(module)(policy["scheduler"])
        cons = (
            cons_cls.make(GRAPH.num_tasks, conditional=spec["conditional"])
            if "conditional" in spec else None
        )
        engines.append(module.MultitaskEngine(
            prog, constraints=cons, hw=msp, policy=policy_cls(**policy),
            **spec["kwargs"],
        ))
    return engines


def type_scheduler(module):
    if module is p_engine:
        return RequestGroupScheduler
    from repro.serving.batching import RequestGroupScheduler as RScheduler
    return RScheduler


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_batch_matches_reference(variant):
    ref_engine, port_engine = _engines(variant)
    assert ref_engine.order == port_engine.order
    for call in range(2):  # a persistent engine: the second call starts warm
        reqs = _requests(14, seed=call)
        ref_reqs = [r_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs]
        port_reqs = [p_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs]

        plan = port_engine.plan_groups(port_reqs)
        ref_plan = ref_engine.plan_groups(ref_reqs)
        assert [(g.indices, g.tasks, g.valid, port_engine.group_order(g)) for g in plan] == [
            (g.indices, g.tasks, g.valid, ref_engine.group_order(g)) for g in ref_plan
        ]
        predicted = port_engine.predicted_group_stats(plan)

        ref_out = ref_engine.serve_batch(ref_reqs)
        port_out = port_engine.serve_batch(port_reqs)
        assert dataclasses.asdict(port_engine.last_batch_stats) == dataclasses.asdict(
            ref_engine.last_batch_stats)
        if "gates" not in VARIANTS[variant]["kwargs"]:
            assert port_engine.last_batch_stats == predicted
        else:  # the prediction assumes every gate fires; some rows did not
            assert port_engine.last_batch_stats.tasks_run < predicted.tasks_run
        assert port_engine.executor.residency_state() == ref_engine.executor.residency_state()
        for r, p in zip(ref_out, port_out):
            assert dataclasses.asdict(r.stats) == dataclasses.asdict(p.stats)
            assert (r.effective_order, r.group_size, r.order) == (
                p.effective_order, p.group_size, p.order)
            assert r.predicted_seconds == p.predicted_seconds
            assert r.warm_weight_bytes_saved == p.warm_weight_bytes_saved
            assert set(r.outputs) == set(p.outputs)
            for t in r.outputs:
                np.testing.assert_allclose(p.outputs[t].numpy(), np.asarray(r.outputs[t]), **TOL)


def test_single_serve_and_group_prediction():
    _ref, port_prog = _programs()
    engine = p_engine.MultitaskEngine(port_prog, hw=P_MSP430)
    x = np.zeros((1, 28, 28, 1), np.float32)
    resp = engine.serve(p_engine.MultitaskRequest(x=x, tasks=[3, 1]))
    assert resp.group_size == 1 and set(resp.outputs) == {1, 3}
    assert resp.outputs[1].shape == (1, 3)
    assert resp.stats == engine.last_batch_stats
    assert resp.stats.tasks_run == 2 and resp.stats.tasks_skipped == 3
    assert engine.normalized_subset(range(5)) is None
    with pytest.raises(ValueError):
        p_engine.MultitaskEngine(port_prog, order=[1, 0, 2, 3, 4],
                                 gates={0: lambda o: True}, gate_deps={0: (1,), 1: (0,)})
