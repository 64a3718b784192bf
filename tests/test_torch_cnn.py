"""The port's LeNet-5 blocks against the JAX package's, at full width.

Weights come from the reference's own initialisers and are carried over as
numpy arrays; the port keeps the NHWC / HWIO layouts at its public
functions.  fp32 outputs agree to 1e-5 (convolutions and products sum in
other orders); block costs are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.task_graph import TaskGraph as RTaskGraph
from repro.models import cnn as r_cnn
from repro.models import multitask as r_mt
from repro_torch.core.task_graph import TaskGraph
from repro_torch.models import cnn as p_cnn
from repro_torch.models import multitask as p_mt

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_block_costs_equal():
    _i, _a, r_costs, r_feat = r_cnn.build_lenet5_blocks()
    _i, _a, p_costs, p_feat = p_cnn.build_lenet5_blocks()
    assert r_feat == p_feat
    assert [dataclasses.asdict(c) for c in r_costs] == [
        dataclasses.asdict(c) for c in p_costs
    ]


@pytest.mark.parametrize("depth", range(4))
def test_each_block_matches_reference(depth):
    r_inits, r_applies, _c, _f = r_cnn.build_lenet5_blocks()
    _i, p_applies, _c, _f = p_cnn.build_lenet5_blocks()
    shapes = [(4, 28, 28, 1), (4, 14, 14, 8), (4, 784), (4, 64)]
    params = r_inits[depth](jax.random.PRNGKey(depth))
    params["b"] = jax.random.normal(jax.random.PRNGKey(10 + depth), params["b"].shape)
    x = _x(shapes[depth], depth)
    ref = r_applies[depth](params, jnp.asarray(x))
    out = p_applies[depth](_t(params), torch.as_tensor(x))
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_layers_and_head_match_reference():
    x = _x((3, 6, 6, 2), 5)
    np.testing.assert_array_equal(
        p_cnn.maxpool2(torch.as_tensor(x)).numpy(), np.asarray(r_cnn.maxpool2(jnp.asarray(x)))
    )
    np.testing.assert_allclose(
        p_cnn.leaky_relu(torch.as_tensor(x)).numpy(),
        np.asarray(r_cnn.leaky_relu(jnp.asarray(x))), **TOL,
    )
    head = r_cnn.head_init(jax.random.PRNGKey(3), 32, 4)
    feats = _x((5, 32), 6)
    np.testing.assert_allclose(
        p_cnn.head_apply(_t(head), torch.as_tensor(feats)).numpy(),
        np.asarray(r_cnn.head_apply(head, jnp.asarray(feats))), **TOL,
    )


def test_init_is_seeded_truncated_and_scaled():
    inits, _a, _c, feat = p_cnn.build_lenet5_blocks()
    a = inits[2](torch.Generator().manual_seed(0), torch.device("cpu"))
    b = inits[2](torch.Generator().manual_seed(0), torch.device("cpu"))
    torch.testing.assert_close(a["w"], b["w"], rtol=0, atol=0)
    std = 1.0 / np.sqrt(784)
    assert a["w"].shape == (784, 64) and float(a["w"].abs().max()) <= 2 * std + 1e-7
    assert abs(float(a["w"].std()) / std - 0.88) < 0.05  # std of N(0,1) cut at +-2
    assert float(a["b"].abs().max()) == 0.0
    head = p_cnn.head_init(torch.Generator().manual_seed(1), feat, 4, torch.device("cpu"))
    assert head["w"].shape == (feat, 4)


@pytest.mark.parametrize("partitions", [
    [[[0, 1, 2]], [[0, 1], [2]], [[0, 1], [2]], [[0], [1], [2]]],
    [[[0], [1], [2]]] * 4,
])
def test_multitask_forward_matches_reference(partitions):
    graph = RTaskGraph.from_groups(partitions)
    ref_prog = r_mt.build_cnn_program(jax.random.PRNGKey(0), graph, [4, 3, 5])
    port_prog = p_mt.program_from_reference(
        TaskGraph(graph.num_tasks, graph.partitions),
        _np(ref_prog.node_params), _np(ref_prog.head_params), device="cpu",
    )
    x = _x((6, 28, 28, 1), 2)
    ref = r_mt.multitask_forward(
        ref_prog, r_mt.program_trainable_params(ref_prog), jnp.asarray(x)
    )
    out = p_mt.multitask_forward(
        port_prog, p_mt.program_trainable_params(port_prog), torch.as_tensor(x)
    )
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_build_cnn_program_shapes():
    graph = TaskGraph.fully_separate(2, 3)
    prog = p_mt.build_cnn_program(
        graph, [4, 7], generator=torch.Generator().manual_seed(0), device="cpu"
    )
    assert prog.device == torch.device("cpu")
    assert set(prog.node_params) == set(graph.nodes())
    assert prog.node_params[(0, (0,))]["w"].shape == (3, 3, 1, 8)
    outs = p_mt.multitask_forward(
        prog, p_mt.program_trainable_params(prog), torch.zeros(2, 28, 28, 1)
    )
    assert [tuple(o.shape) for o in outs] == [(2, 4), (2, 7)]
    with pytest.raises(ValueError):
        p_mt.build_cnn_program(
            TaskGraph.fully_separate(2, 2), [4, 4],
            generator=torch.Generator(), device="cpu",
        )
