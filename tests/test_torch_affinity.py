"""The port's affinity analysis against the JAX package's.

Tolerances: ranks are exact (the same fp32 sums); Spearman and the affinity
matrix on the *same* profiles agree to 1e-6 (fp32 dot products summed in
another order); profiles agree to 1e-5 (two fp32 Gram products).  End to
end from images the affinity is held to 2e-3 instead: profiles computed by
two different GEMMs differ in their last bits, symmetric entries included,
and Spearman ranks those entries — a one-ulp difference between two nearly
equal dissimilarities swaps their ranks (observed: up to 1.6e-4 on 16
probes).  The selected task graph must be the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.core import affinity as r_aff
from repro.core import tradeoff as r_tr
from repro.core.task_graph import TaskGraph as RTaskGraph
from repro.core.types import MSP430 as R_MSP430
from repro.models import cnn as r_cnn
from repro.models import multitask as r_mt
from repro_torch.core import affinity as p_aff
from repro_torch.core import tradeoff as p_tr
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import MSP430 as P_MSP430
from repro_torch.models import cnn as p_cnn
from repro_torch.models import multitask as p_mt


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("seed,levels", [(0, 3), (1, 10), (2, None)])
def test_rankdata_matches_reference_with_ties(seed, levels):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, levels, 200) if levels else rng.standard_normal(200)).astype(np.float32)
    ref = np.asarray(r_aff._rankdata(jnp.asarray(x)))
    out = p_aff._rankdata(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(out, scipy.stats.rankdata(x, method="average"), rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_spearman_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(300).astype(np.float32)
    b = (a + rng.standard_normal(300) * (seed + 0.5)).round(1).astype(np.float32)
    ref = float(r_aff.spearman(jnp.asarray(a), jnp.asarray(b)))
    out = float(p_aff.spearman(torch.as_tensor(a), torch.as_tensor(b)))
    assert abs(out - ref) <= 1e-6
    assert float(p_aff.spearman(torch.zeros(10), torch.as_tensor(a[:10]))) == 0.0


def _reference_profiles(k=24, seed=0):
    rng = np.random.default_rng(seed)
    reps = [
        [rng.standard_normal((k, f)).astype(np.float32) for f in (40, 20, 8)]
        for _ in range(4)
    ]
    reps[1][0] = reps[0][0] + 0.1 * reps[1][0]  # task 1 resembles task 0
    return reps


def test_profile_task_matches_reference():
    for reps in _reference_profiles():
        ref = np.asarray(r_aff.profile_task([jnp.asarray(r) for r in reps]))
        out = p_aff.profile_task([torch.as_tensor(r) for r in reps])
        assert tuple(out.shape) == ref.shape == (3, 24, 24)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_affinity_matrix_on_reference_profiles():
    """Bit-equal profiles in, so ties are ranked identically."""
    profiles = [
        r_aff.profile_task([jnp.asarray(r) for r in reps])
        for reps in _reference_profiles()
    ]
    ref = np.asarray(r_aff.affinity_matrix(profiles))
    out = p_aff.affinity_matrix([torch.tensor(np.asarray(p)) for p in profiles]).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np.diagonal(out, axis1=1, axis2=2), 1.0, atol=1e-6)


def test_compute_affinity_matches_reference():
    reps = _reference_profiles(k=16, seed=4)
    ref = np.asarray(r_aff.compute_affinity(
        lambda _s, t: [jnp.asarray(r) for r in reps[t]], 4, jnp.zeros(16)))
    out = p_aff.compute_affinity(
        lambda _s, t: [torch.as_tensor(r) for r in reps[t]], 4, torch.zeros(16)).numpy()
    # Profiles from two GEMMs: last-bit differences reorder near-ties.
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


def _taps(block_fns, node_params, graph, task, x):
    taps, h = [], x
    for d, node in enumerate(graph.path(task)[:3]):
        h = block_fns[d](node_params[node], h)
        taps.append(h.reshape(h.shape[0], -1))
    return taps


def test_images_to_selected_graph_matches_reference():
    """The quickstart's steps 2-3 (random weights, no training) at a small
    size: LeNet taps at the 3 branch points of 4 per-task networks over 32
    probes, affinity, then graph selection."""
    n = 4
    graph = RTaskGraph.fully_separate(n, 3)
    ref_prog = r_mt.build_cnn_program(jax.random.PRNGKey(0), graph, [4] * n)
    port_prog = p_mt.program_from_reference(
        TaskGraph(n, graph.partitions), _np(ref_prog.node_params),
        _np(ref_prog.head_params), device="cpu",
    )
    x = np.random.default_rng(0).standard_normal((32, 28, 28, 1)).astype(np.float32)
    ref_aff = np.asarray(r_aff.affinity_matrix([
        r_aff.profile_task(_taps(ref_prog.block_fns, ref_prog.node_params, graph, t,
                                 jnp.asarray(x)))
        for t in range(n)
    ]))
    out_aff = p_aff.affinity_matrix([
        p_aff.profile_task(_taps(port_prog.block_fns, port_prog.node_params,
                                 port_prog.graph, t, torch.as_tensor(x)))
        for t in range(n)
    ]).numpy()
    np.testing.assert_allclose(out_aff, ref_aff, atol=2e-3, rtol=0)
    _i, _a, r_costs, _f = r_cnn.build_lenet5_blocks()
    _i, _a, p_costs, _f = p_cnn.build_lenet5_blocks()
    ref_sel = r_tr.select_task_graph(n, 3, ref_aff, r_costs, R_MSP430).selected
    out_sel = p_tr.select_task_graph(n, 3, out_aff, p_costs, P_MSP430).selected
    assert out_sel.graph.partitions == ref_sel.graph.partitions
    assert out_sel.order == ref_sel.order
