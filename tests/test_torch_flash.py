"""The port's flash attention against the JAX package's.

On the CPU the port's wrappers run their plain version
(``kernels/ref.py::flash_attention_ref``); it is held against the Pallas
kernel in interpret mode and against the reference's own oracles, at the
reference sweep's shapes (``tests/test_kernels.py``) plus the zoo's head_dim
160, grouped-query layouts and the sliding window.  Tolerances are the
sweep's: fp32 2e-5 (softmax and two products summed in other orders), bf16
2e-2 (one bf16 rounding of the output, either side).  The CUDA kernel runs
only on a card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.models import layers as r_layers
from repro_torch.kernels import _build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, _check_rows, flash_attention

MODES = [(True, None), (False, None), (True, 24)]
# (s, t, d): the reference sweep, then the zoo's d = 160 (mistral-nemo-12b)
# and d = 80 (zamba2-2.7b's shared attention).
SHAPES = [(32, 32, 16), (70, 70, 32), (48, 96, 64), (40, 40, 160), (66, 66, 80)]
CASES = [
    (s, t, d, causal, window)
    for (s, t, d) in SHAPES for (causal, window) in MODES
    if causal or s == t  # the reference's oracle is square when not causal
]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _qkv(shape_q, shape_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal(shape_kv).astype(np.float32)
    v = rng.standard_normal(shape_kv).astype(np.float32)
    if dtype == "bfloat16":  # equal bf16 values on both sides
        q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (q, k, v))
    return q, k, v


def _port(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,d,causal,window", CASES)
def test_flat_matches_pallas_interpret_and_ref(s, t, d, causal, window, dtype):
    q, k, v = _qkv((2, s, d), (2, t, d), dtype, seed=s * t + d)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    pallas = r_flash(jq, jk, jv, causal=causal, window=window, q_blk=16, kv_blk=16)
    oracle = r_ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    out = flash_attention(_port(q, dtype), _port(k, dtype), _port(v, dtype),
                          causal=causal, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, s, d)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(out), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("hq,hk", [(4, 4), (8, 2), (6, 1), (32, 8)])
@pytest.mark.parametrize("window", [None, 24])
def test_gqa_model_layout_matches_reference(hq, hk, window):
    """``flash_attention_bhsd`` vs the reference wrapper (Pallas, interpret,
    which repeats KV heads) and the model's dense attention."""
    q, k, v = _qkv((2, 33, hq, 16), (2, 33, hk, 16), "float32", seed=hq * 10 + hk)
    pallas = r_ops.flash_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window, q_blk=16, kv_blk=16)
    pos = jnp.arange(33)
    dense = r_layers.attention_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos, window=window)
    out = p_ops.flash_attention_bhsd(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), window=window)
    assert out.shape == (2, 33, hq, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(dense), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hq,hk,dtype", [(6, 1, "float32"), (32, 8, "bfloat16")])
def test_flat_gqa_equals_model_layout(hq, hk, dtype):
    """A (B*Hq, S, d) query over (B*Hk, T, d) keys is the model layout's
    grouped attention, flattened: query slice i reads KV slice i // (Hq/Hk)."""
    b, s, d = 2, 33, 160
    q, k, v = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in _qkv(
        (b, s, hq, d), (b, s, hk, d), dtype, seed=7))
    model = p_ops.flash_attention_bhsd(q, k, v)
    flat = flash_attention(
        q.transpose(1, 2).reshape(b * hq, s, d),
        k.transpose(1, 2).reshape(b * hk, s, d),
        v.transpose(1, 2).reshape(b * hk, s, d),
    )
    torch.testing.assert_close(flat.reshape(b, hq, s, d).transpose(1, 2), model,
                               rtol=0, atol=0)


def test_cpu_route_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.as_tensor(a) for a in _qkv((3, 20, 32), (3, 20, 32), "float32", 1))
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=5)
    assert flash_attention.launches == before
    assert torch.equal(out, p_ref.flash_attention_ref(q, k, v, window=5))
    assert p_ops.flash_attention_bhsd(q[None], k[None], v[None]).shape == (1, 3, 20, 32)


def test_meta_tensor_raises_value_error():
    """The executor's shape probe reads ValueError as "cannot run abstractly"."""
    q = torch.empty(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError):
        p_ops.flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_refuses_exactly_the_rows_without_keys(causal):
    """The kernel's guard raises iff some query row keeps no key under the
    masks, the one case where kernel and plain version would differ."""
    for s, t, w in [(16, 8, 4), (11, 8, 4), (12, 8, 4), (8, 8, 1), (20, 0, None),
                    (40, 8, None), (1, 65, 3), (70, 70, 24)]:
        i = np.arange(s)[:, None]
        j = np.arange(t)[None, :]
        keep = np.ones((s, t), bool) if not causal else i >= j
        if w is not None:
            keep &= i - j < w
        empty = not keep.any(axis=1).all() if s else False
        if empty:
            with pytest.raises(ValueError):
                _check_rows(s, t, w)
        else:
            _check_rows(s, t, w)


def test_kernel_source_and_head_dims():
    """Every head_dim the wrapper accepts has a template instance, and the
    library path is named by the source's hash (built at first launch)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for d in HEAD_DIMS:
        assert f"case {d}: return launch<T, {d}>" in src
    assert 160 in HEAD_DIMS and 80 in HEAD_DIMS
    path = _build.library_path("flash_attention.cu")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("flash_attention-")
