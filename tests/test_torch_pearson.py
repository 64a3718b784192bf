"""The port's Pearson Gram against the JAX package's.

On the CPU the wrapper runs its plain version; it is held against the Pallas
kernel in interpret mode and against the jnp twin in ``core/affinity.py``,
at the reference sweep's shapes and tolerances
(``tests/test_kernels.py::test_pearson_sweep``): fp32 1e-5 (two fp32 GEMMs
that sum in different orders), bf16 inputs 5e-2 (the sweep's bf16 bound;
both sides cast the bf16 values to fp32 before standardising, so in fact
they agree far closer).  The CUDA kernel itself runs only on a
card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import affinity as r_aff
from repro.kernels import ops as r_ops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels.pearson_affinity import (
    CHUNK, TARGET_BLOCKS, pearson_dissimilarity, split_plan,
)
from repro_torch.kernels.ref import pearson_dissimilarity_ref

SHAPES = [(16, 64), (37, 100), (64, 300)]


def _feats(k, f):
    return np.random.default_rng(k * 1000 + f).standard_normal((k, f)).astype(np.float32)


@pytest.mark.parametrize("k,f", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_path_matches_pallas_interpret(k, f, dtype):
    x = _feats(k, f)
    ref = r_ops.pairwise_pearson_dissimilarity(
        jnp.asarray(x).astype(dtype), blk_k=16, blk_f=32, interpret=True
    )
    out = p_ops.pairwise_pearson_dissimilarity(
        torch.as_tensor(x).to(getattr(torch, dtype))
    )
    assert out.dtype == torch.float32 and out.shape == (k, k)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("k,f", SHAPES)
def test_cpu_path_matches_jnp_twin(k, f):
    x = _feats(k, f)
    ref = r_aff.pairwise_pearson_dissimilarity(jnp.asarray(x))
    out = p_ops.pairwise_pearson_dissimilarity(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_standardisation_matches_reference():
    x = _feats(37, 100)
    z = np.asarray(r_aff._standardize_rows(jnp.asarray(x)))
    np.testing.assert_allclose(
        p_ops.standardize_rows(torch.as_tensor(x)).numpy(), z, atol=1e-6, rtol=1e-6
    )


def test_cpu_tensor_never_takes_the_kernel_branch(monkeypatch):
    def no_build(*_args, **_kwargs):
        raise AssertionError("the CUDA kernel was built for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    before = pearson_dissimilarity.launches
    z = p_ops.standardize_rows(torch.as_tensor(_feats(16, 64)))
    out = pearson_dissimilarity(z)
    torch.testing.assert_close(out, pearson_dissimilarity_ref(z), rtol=0, atol=0)
    assert pearson_dissimilarity.launches == before


@pytest.mark.parametrize("bad,error", [
    (lambda: torch.empty((8, 4), dtype=torch.bfloat16, device="meta"), TypeError),
    (lambda: torch.empty((8, 4, 2), device="meta"), ValueError),
    (lambda: torch.empty((4, 8), device="meta").T, ValueError),
    (lambda: torch.empty((8,), device="meta"), ValueError),
])
def test_non_cpu_inputs_are_checked_before_any_launch(bad, error, monkeypatch):
    """A non-CPU tensor must be fp32, 2-D and contiguous; anything else
    raises before the kernel is built.  Meta tensors stand in for device
    tensors on a host without a card."""
    monkeypatch.setattr(_build, "load", lambda *_a: pytest.fail("kernel built"))
    with pytest.raises(error):
        pearson_dissimilarity(bad())


def test_meta_input_returns_the_output_shape_without_a_launch(monkeypatch):
    """A valid ``meta`` input (a shape run) gives the (K, K) fp32 output on
    ``meta``: nothing is built or launched or counted as a launch."""
    monkeypatch.setattr(_build, "load", lambda *_a: pytest.fail("kernel built"))
    before = pearson_dissimilarity.launches
    out = pearson_dissimilarity(torch.empty((8, 4), device="meta"))
    assert out.device.type == "meta" and out.shape == (8, 8) and out.dtype == torch.float32
    assert pearson_dissimilarity.launches == before


PLAN_SHAPES = [(256, 655360), (512, 1568), (512, 784), (512, 64), (37, 100), (130, 7),
               (64, 300), (300, 5000), (200, 10001), (2048, 1568), (1, 0)]


@pytest.mark.parametrize("k,f", PLAN_SHAPES)
def test_split_plan_covers_the_features_in_order(k, f):
    """The splits tile [0, F) exactly, in order, each starting on a chunk
    boundary and all but the last a whole number of chunks long."""
    plan = split_plan(k, f)
    ranges = plan.ranges(f)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == f
    for (_a, stop), (start, _b) in zip(ranges, ranges[1:]):
        assert stop == start
    for start, stop in ranges[:-1]:
        assert start % CHUNK == 0 and stop - start == plan.span and plan.span % CHUNK == 0
    assert ranges[-1][0] % CHUNK == 0 and 0 <= ranges[-1][1] - ranges[-1][0] <= plan.span
    tiles = -(-k // 64)
    assert plan.pairs == tiles * (tiles + 1) // 2
    assert plan.blocks <= max(TARGET_BLOCKS, plan.pairs)


def test_split_plan_depends_on_shape_alone(monkeypatch):
    """No query of the card: the same (K, F) gives the same plan whatever
    device is present, so the summation order and the bits do not depend on
    the card."""
    def no_card(*_a, **_k):
        raise AssertionError("split_plan asked the device")

    for name in ("device_count", "get_device_properties", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    plans = [split_plan(k, f) for k, f in PLAN_SHAPES]
    assert plans == [split_plan(k, f) for k, f in PLAN_SHAPES]
    assert len({split_plan(256, 655360), split_plan(512, 1568)}) == 2


def test_split_plan_fills_the_card_at_the_main_shapes():
    """At least two blocks per SM of a 132-SM H100 at the transformer
    profile's shape; more than one split at the LeNet path's, whose F holds
    7 chunks, and as many splits as it has chunks."""
    big = split_plan(256, 655360)
    assert big.blocks >= 2 * 132
    small = split_plan(512, 1568)
    assert small.splits == 7 and small.span == CHUNK
