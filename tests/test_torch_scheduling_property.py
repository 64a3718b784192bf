"""Properties of the port's request-group scheduler and grouped serving,
re-pointed from ``tests/test_batch_scheduler_property.py``.

* every submitted request appears in exactly one group;
* groups are homogeneous — one task subset and one input shape per group;
* group widths come from the scheduler's allowed batch shapes, and padding
  never changes served results (the reference's ``rtol=1e-5, atol=1e-6``);
* warm multi-group serving (cross-group residency reuse + cost-aware group
  ordering) returns the same outputs as the cold-per-group path, and the
  warm engine's cumulative counters equal
  ``MultitaskEngine.predicted_group_stats`` of its plan exactly.

Hypothesis runs derandomized (``derandomize=True, database=None``), so the
examples are the same on every run.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import BlockCost, MSP430, MultitaskProgram
from repro_torch.core.task_graph import TaskGraph
from repro_torch.serving import (
    MultitaskEngine, MultitaskRequest, RequestGroupScheduler,
)

DIM = 8
GRAPH = TaskGraph.from_groups([
    [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2, 3]],
])
SUBSET_CHOICES = (None, (0,), (1, 2), (0, 3), (2, 1), (0, 1, 2, 3))


def _block(p, x):
    return torch.tanh(x @ p)


def _head(p, x):
    return x @ p


def _program(seed=0):
    rng = np.random.default_rng(seed)
    costs = [BlockCost(weight_bytes=10.0, flops=1.0) for _ in range(GRAPH.depth)]
    node_params = {
        node: torch.tensor(rng.normal(size=(DIM, DIM)), dtype=torch.float32)
        for node in GRAPH.nodes()
    }
    head_params = [torch.tensor(rng.normal(size=(DIM, 3)), dtype=torch.float32)
                   for _ in range(4)]
    return MultitaskProgram(
        GRAPH, [_block] * GRAPH.depth, node_params, [_head] * 4, head_params, costs
    )


PROGRAM = _program()


def _requests_from_spec(spec, rng):
    """spec: list of (subset_index, wide_input) pairs."""
    reqs = []
    for subset_idx, wide in spec:
        shape = (2, DIM) if wide else (DIM,)
        reqs.append(MultitaskRequest(
            x=torch.tensor(rng.normal(size=shape), dtype=torch.float32),
            tasks=SUBSET_CHOICES[subset_idx],
        ))
    return reqs


def _norm(subset):
    return None if subset is None else frozenset(int(t) for t in subset)


def check_plan_invariants(requests, batch_shapes):
    sched = RequestGroupScheduler(batch_shapes=batch_shapes)
    groups = sched.plan(requests)

    # Exactly-one-group partition of the submitted indices.
    covered = [i for g in groups for i in g.indices]
    assert sorted(covered) == list(range(len(requests)))

    for g in groups:
        assert g.valid == len(g.indices) == len(g.requests)
        # Width is an allowed batch shape, large enough for the members.
        assert int(g.xs.shape[0]) in sched.batch_shapes
        assert int(g.xs.shape[0]) >= g.valid
        # Homogeneity: one subset, one sample shape for the whole group.
        for i, r in zip(g.indices, g.requests):
            assert requests[i] is r
            assert _norm(r.tasks) == g.tasks
            assert tuple(torch.as_tensor(r.x).shape) == tuple(g.xs.shape[1:])
        # Padding rows replicate the last real row.
        for p in range(g.valid, int(g.xs.shape[0])):
            np.testing.assert_array_equal(
                g.xs[p].numpy(), g.xs[g.valid - 1].numpy())
    return groups


def check_padding_preserves_results(requests):
    """Padded grouped serving == unbatched serving, request by request."""
    eng = MultitaskEngine(PROGRAM, hw=MSP430,
                          scheduler=RequestGroupScheduler(batch_shapes=(1, 4)))
    solo = MultitaskEngine(PROGRAM, hw=MSP430,
                           scheduler=RequestGroupScheduler(batch_shapes=(1,)))
    for rb, req in zip(eng.serve_batch(requests), requests):
        rs = solo.serve(req)
        assert set(rb.outputs) == set(rs.outputs)
        for t in rb.outputs:
            np.testing.assert_allclose(
                rb.outputs[t].numpy(), rs.outputs[t].numpy(),
                rtol=1e-5, atol=1e-6)


def check_warm_multigroup_equivalence(requests):
    """Warm multi-group serving == cold-per-group serving, and the warm
    engine's cumulative counters match ``predicted_group_stats`` exactly.

    Serves the same stream twice so the second batch starts warm from the
    first's residency (the persistent-engine case).
    """
    warm = MultitaskEngine(PROGRAM, hw=MSP430,
                           scheduler=RequestGroupScheduler(batch_shapes=(1, 4)))
    cold = MultitaskEngine(PROGRAM, hw=MSP430, warm_start=False,
                           group_ordering=False,
                           scheduler=RequestGroupScheduler(batch_shapes=(1, 4)))
    for _round in range(2):
        pred = warm.predicted_group_stats(warm.plan_groups(requests))
        warm_resp = warm.serve_batch(requests)
        cold_resp = cold.serve_batch(requests)
        assert warm.last_batch_stats == pred
        # Warmth + ordering only remove loads, never add them.
        assert (warm.last_batch_stats.weight_bytes_loaded
                <= cold.last_batch_stats.weight_bytes_loaded)
        # Per-request counters are schedule-independent.
        assert warm.last_batch_stats.flops_executed == \
            cold.last_batch_stats.flops_executed
        assert warm.last_batch_stats.tasks_run == cold.last_batch_stats.tasks_run
        for rw, rc in zip(warm_resp, cold_resp):
            assert set(rw.outputs) == set(rc.outputs)
            for t in rw.outputs:
                np.testing.assert_allclose(
                    rw.outputs[t].numpy(), rc.outputs[t].numpy(),
                    rtol=1e-5, atol=1e-6)


def test_scheduler_invariants_fixed_seeds():
    rng = np.random.default_rng(0)
    for trial in range(25):
        n = int(rng.integers(1, 12))
        spec = [(int(rng.integers(0, len(SUBSET_CHOICES))),
                 bool(rng.integers(0, 2))) for _ in range(n)]
        reqs = _requests_from_spec(spec, rng)
        check_plan_invariants(reqs, batch_shapes=(1, 2, 4))
        check_plan_invariants(reqs, batch_shapes=(1, 4, 16, 64))


def test_scheduler_chunks_oversized_buckets():
    rng = np.random.default_rng(1)
    reqs = _requests_from_spec([(0, False)] * 11, rng)  # one big bucket
    groups = check_plan_invariants(reqs, batch_shapes=(1, 2, 4))
    assert all(g.valid <= 4 for g in groups)
    assert len(groups) == 3  # 4 + 4 + 3


def test_chunk_sizes_avoid_gross_padding():
    sched = RequestGroupScheduler(batch_shapes=(1, 4, 16, 64))
    # Peel exact shapes instead of padding 17 -> 64 (3.7x wasted rows).
    assert sched.chunk_sizes(17) == [(16, 16), (1, 1)]
    assert sched.chunk_sizes(5) == [(4, 4), (1, 1)]
    # <= 50% waste pads up: one group amortises loads better than several.
    assert sched.chunk_sizes(3) == [(3, 4)]
    assert sched.chunk_sizes(2) == [(2, 4)]
    assert sched.chunk_sizes(64) == [(64, 64)]
    assert sched.chunk_sizes(80) == [(64, 64), (16, 16)]
    # Remainder below the smallest shape must pad up.
    assert RequestGroupScheduler(batch_shapes=(4,)).chunk_sizes(1) == [(1, 4)]


def test_scheduler_rejects_bad_shapes():
    # The reference's padded_size has no caller and is not ported.
    with pytest.raises(ValueError):
        RequestGroupScheduler(batch_shapes=())
    with pytest.raises(ValueError):
        RequestGroupScheduler(batch_shapes=(0, 4))


def test_padding_preserves_results_fixed_seed():
    rng = np.random.default_rng(2)
    spec = [(int(rng.integers(0, len(SUBSET_CHOICES))), False)
            for _ in range(7)]
    check_padding_preserves_results(_requests_from_spec(spec, rng))


def test_warm_multigroup_equivalence_fixed_seeds():
    rng = np.random.default_rng(3)
    for _trial in range(4):
        n = int(rng.integers(2, 10))
        spec = [(int(rng.integers(0, len(SUBSET_CHOICES))), False)
                for _ in range(n)]
        check_warm_multigroup_equivalence(_requests_from_spec(spec, rng))


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(
    spec=st.lists(
        st.tuples(st.integers(0, len(SUBSET_CHOICES) - 1), st.booleans()),
        min_size=1, max_size=12,
    ),
    data_seed=st.integers(0, 2**16),
)
def test_scheduler_invariants_hypothesis(spec, data_seed):
    rng = np.random.default_rng(data_seed)
    reqs = _requests_from_spec(spec, rng)
    check_plan_invariants(reqs, batch_shapes=(1, 2, 4))

@settings(max_examples=10, deadline=None)
@given(
    spec=st.lists(
        st.tuples(st.integers(0, len(SUBSET_CHOICES) - 1), st.just(False)),
        min_size=1, max_size=6,
    ),
    data_seed=st.integers(0, 2**16),
)
def test_padding_preserves_results_hypothesis(spec, data_seed):
    rng = np.random.default_rng(data_seed)
    check_padding_preserves_results(_requests_from_spec(spec, rng))

@settings(max_examples=10, deadline=None)
@given(
    spec=st.lists(
        st.tuples(st.integers(0, len(SUBSET_CHOICES) - 1), st.just(False)),
        min_size=1, max_size=8,
    ),
    data_seed=st.integers(0, 2**16),
)
def test_warm_multigroup_equivalence_hypothesis(spec, data_seed):
    rng = np.random.default_rng(data_seed)
    check_warm_multigroup_equivalence(_requests_from_spec(spec, rng))
