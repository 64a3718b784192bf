"""The plain SSD backward against the JAX package's autodiff.

:func:`repro_torch.kernels.ref.ssd_scan_bwd_ref` (the vector-Jacobian
product of the chunked SSD, written out in the backward kernel's phases)
is held against ``jax.vjp`` of the reference's ``models/ssm.py::ssd_chunked``
and against torch autograd of the per-step recurrence in float64 (and, on
the CPU wrapper, of the port's ``ssd_chunked``), at the
reference sweep's shapes, the smoke configs' and a model's (P, N), chunks 8
to 256, ragged lengths, with and without a cotangent of the final state.
Inputs are drawn with numpy from a seed (the sweep's distributions).

Tolerances: each gradient within 2e-4 of its largest |value| in fp32 (sums
over the chunk in other orders; the cumulative sum rounds at long chunks);
5e-2 from bf16 inputs (dx, dB and dC rounded to bf16 once).

Where a masked ``exp(cum_i - cum_j)`` above the diagonal overflows fp32
(|cum| spreads past 88 within a chunk), autodiff of ``ssd_chunked`` gives
NaN for dt and a in both packages (in float64 too, past a spread of
709): the select's zero cotangent times the
overflowed exp's own derivative is 0 * inf.  The written-out backward never
forms that product.  There the reference's dt and a gradients are taken
from ``jax.vjp`` of its per-step recurrence (``ssd_decode_step`` over the
sequence), the same function without the chunked form's masked exps.  The
CUDA kernels (``csrc/ssd_scan.cu::ssd_scan_bwd``) run only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as r_ssm
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ssd_scan as p_ssd
from repro_torch.kernels.ref import ssd_scan_bwd_ref

FP32_TOL, BF16_TOL = 2e-4, 5e-2
NAMES = ("dx", "ddt", "da", "dB", "dC")
# (batch, s, h, p, n, chunk): the reference sweep (tests/test_kernels.py);
# the smoke configs' (P, N) at a ragged length; a model's (P, N) ragged
# over two chunks; chunks 128 and 256, ragged.
SHAPES = [
    (2, 24, 2, 4, 8, 8), (2, 50, 3, 8, 4, 16), (2, 64, 4, 16, 16, 32),
    (2, 45, 2, 32, 16, 32), (1, 70, 2, 64, 128, 64), (1, 200, 2, 8, 8, 128),
    (1, 300, 2, 16, 16, 256),
]


def _inputs(b, s, h, p, n, seed):
    """x, B, C, dy and d_final standard normal, dt = softplus(normal),
    a = -exp(normal), fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    d_final = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bb, cc), dy, d_final


def _recurrence(x, dt, a, b_in, c_in):
    """The reference's per-step recurrence: its ``ssd_decode_step`` over the
    sequence from a zero state (``ssd_sequential_ref`` with the loop as a
    ``lax.scan``, which compiles in a time that does not grow with S)."""
    bsz, _s, h, p = x.shape
    state = jnp.zeros((bsz, h, p, b_in.shape[-1]), jnp.float32)

    def step(st, xs):
        y, st = r_ssm.ssd_decode_step(st, xs[0], xs[1], a, xs[2], xs[3])
        return st, y

    xs = tuple(jnp.swapaxes(t, 0, 1) for t in (x, dt, b_in, c_in))
    final, ys = jax.lax.scan(step, state, xs)
    return jnp.swapaxes(ys, 0, 1), final


@functools.lru_cache(maxsize=None)
def _jax_vjp(chunk):
    """jitted (inputs, dy, d_final) -> the five cotangents of the
    reference's chunked SSD (``chunk`` None: its per-step recurrence)."""
    if chunk is None:
        fn = _recurrence
    else:
        def fn(*args):
            return r_ssm.ssd_chunked(*args, chunk=chunk)

    @jax.jit
    def vjp(args, dy, d_final):
        _out, pull = jax.vjp(fn, *args)
        return pull((dy, d_final))

    return vjp


def _reference(args, dy, d_final, chunk):
    """jax.vjp of ``ssd_chunked``; a gradient it leaves non-finite (the
    masked exp's 0 * inf, module doc) from the per-step recurrence."""
    jargs = tuple(jnp.asarray(a) for a in args)
    want = [np.asarray(g) for g in _jax_vjp(chunk)(jargs, jnp.asarray(dy), jnp.asarray(d_final))]
    if all(np.isfinite(g).all() for g in want):
        return want, ()
    seq = [np.asarray(g) for g in _jax_vjp(None)(jargs, jnp.asarray(dy), jnp.asarray(d_final))]
    replaced = tuple(NAMES[i] for i, g in enumerate(want) if not np.isfinite(g).all())
    assert set(replaced) <= {"ddt", "da"}, replaced
    return [s if not np.isfinite(w).all() else w for w, s in zip(want, seq)], replaced


def _float64_autograd(args, dy, d_final, chunk=None):
    """Torch autograd, in float64, of the per-step recurrence from a zero
    state (``s_t = exp(dt_t a) s_{t-1} + dt_t x_t (x) B_t``, ``y_t = C_t .
    s_t``): the exact function with no masked exp to overflow."""
    x, dt, a, bb, cc = (torch.as_tensor(v, dtype=torch.float64).requires_grad_(True)
                        for v in args)
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], bb.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * bb[:, t, None, None, :]
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cc[:, t]))
    loss = (torch.stack(ys, dim=1) * torch.as_tensor(dy, dtype=torch.float64)).sum()
    if d_final is not None:
        loss = loss + (state * torch.as_tensor(d_final, dtype=torch.float64)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (x, dt, a, bb, cc))]


def _assert_close(got, want, tol, what):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g.float().numpy() if torch.is_tensor(g) else g, np.float64)
        w = np.asarray(w, np.float64)
        assert np.isfinite(g).all(), f"{what} {name}: non-finite"
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{what} {name}: {err:.3g} of its largest |value| > {tol}"


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_bwd_ref_matches_jax_vjp(b, s, h, p, n, chunk, with_final):
    args, dy, d_final = _inputs(b, s, h, p, n, seed=s + h + n)
    if not with_final:
        d_final = np.zeros_like(d_final)
    got = ssd_scan_bwd_ref(*(torch.as_tensor(a) for a in args), torch.as_tensor(dy),
                           torch.as_tensor(d_final) if with_final else None, chunk)
    assert [tuple(g.shape) for g in got] == [a.shape for a in args]
    assert all(g.dtype == torch.float32 for g in got)
    want, _replaced = _reference(args, dy, d_final, chunk)
    _assert_close(got, want, FP32_TOL, f"vs jax.vjp {(b, s, h, p, n, chunk)}")


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_bwd_ref_matches_float64_autograd(b, s, h, p, n, chunk, with_final):
    args, dy, d_final = _inputs(b, s, h, p, n, seed=3 * s + n)
    d_final = d_final if with_final else None
    got = ssd_scan_bwd_ref(*(torch.as_tensor(a) for a in args), torch.as_tensor(dy),
                           None if d_final is None else torch.as_tensor(d_final), chunk)
    _assert_close(got, _float64_autograd(args, dy, d_final, chunk), FP32_TOL,
                  f"vs float64 autograd {(b, s, h, p, n, chunk)}")


def test_reference_autodiff_overflows_where_the_written_out_backward_does_not():
    """The quirk the module doc names, shown once: at chunk 32 with |cum|
    spreading past 88, jax.vjp of ``ssd_chunked`` gives NaN for dt and a,
    the written-out backward finite values equal to the float64 ones."""
    args, dy, d_final = _inputs(2, 45, 2, 32, 16, seed=45)
    jargs = tuple(jnp.asarray(a) for a in args)
    raw = _jax_vjp(32)(jargs, jnp.asarray(dy), jnp.asarray(np.zeros_like(d_final)))
    assert not np.isfinite(np.asarray(raw[1])).all() and not np.isfinite(np.asarray(raw[2])).all()
    got = ssd_scan_bwd_ref(*(torch.as_tensor(a) for a in args), torch.as_tensor(dy), None, 32)
    _assert_close(got, _float64_autograd(args, dy, None, 32), FP32_TOL, "overflowing spread")


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 45, 2, 32, 16, 32), (1, 70, 2, 64, 128, 64)])
def test_bwd_ref_from_bf16_inputs(b, s, h, p, n, chunk):
    """bf16 x, B, C and dy: widened to fp32, dx, dB and dC rounded to bf16
    once; held against float64 autograd of the same bf16 values."""
    args, dy, d_final = _inputs(b, s, h, p, n, seed=s)
    x, dt, a, bb, cc = (torch.as_tensor(v) for v in args)
    x, bb, cc, dyb = (t.to(torch.bfloat16) for t in (x, bb, cc, torch.as_tensor(dy)))
    got = ssd_scan_bwd_ref(x, dt, a, bb, cc, dyb, torch.as_tensor(d_final), chunk)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    widened = [t.float().numpy() for t in (x, dt, a, bb, cc)]
    want = _float64_autograd(widened, dyb.float().numpy(), d_final, chunk)
    _assert_close(got, want, BF16_TOL, f"bf16 {(b, s, h, p, n, chunk)}")


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 50, 3, 8, 4, 16), (1, 70, 2, 64, 128, 64)])
def test_cpu_wrapper_differentiates_the_plain_version(b, s, h, p, n, chunk):
    """On the CPU ``ops.ssd_scan`` under autograd is the plain version's
    autograd (no kernel, no backward launch), and agrees with the
    written-out backward."""
    args, dy, d_final = _inputs(b, s, h, p, n, seed=11 * s)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in args]
    fwd, bwd = p_ssd.ssd_scan.launches, p_ssd.ssd_scan.backward_launches
    y, fin = p_ops.ssd_scan(*leaves, chunk=chunk)
    loss = (y * torch.as_tensor(dy)).sum() + (fin * torch.as_tensor(d_final)).sum()
    auto = torch.autograd.grad(loss, leaves)
    assert (p_ssd.ssd_scan.launches, p_ssd.ssd_scan.backward_launches) == (fwd, bwd)
    got = ssd_scan_bwd_ref(*(t.detach() for t in leaves), torch.as_tensor(dy),
                           torch.as_tensor(d_final), chunk)
    _assert_close(got, [g.numpy() for g in auto], FP32_TOL, "CPU autograd")


def test_backward_scratch_at_the_model_shapes():
    """The backward's fp32 scratch: the per-chunk states and cotangents
    dominate.  bf16 (the tensor-core kernels) keeps dB and dC once per head
    group (``backward_groups``: 8 heads a group at both shapes) and no
    C_I B_J^T; fp32 (the CUDA-core kernels) keeps them per head and C_I
    B_J^T once per chunk and pair of sub-tiles (mamba2-780m: 4 x 2048
    tokens, 48 heads, P 64, N 128, chunk 64; zamba2-2.7b: 4 x 1024, 80
    heads, N 64, chunk 256)."""
    shapes = p_ssd.backward_scratch_shapes(4, 2048, 48, 64, 128, 64, torch.bfloat16)
    assert list(shapes) == ["cum", "decay", "states", "cotangents", "state_dots", "ddt_x",
                            "dcum_k", "t", "dcum_q", "db_groups", "dc_groups", "da_chunks"]
    with pytest.raises(TypeError):  # the layout depends on the dtype: no default
        p_ssd.backward_scratch_shapes(4, 2048, 48, 64, 128, 64)
    assert shapes["states"][0] == (4, 32, 48, 64, 128)
    assert shapes["state_dots"][0] == (4, 32, 48, 64)
    assert shapes["db_groups"][0] == (4, 2048, 6, 128)
    assert p_ssd.backward_groups(4, 2048, 48, 64) == (8, 8)
    assert p_ssd.backward_scratch_shapes(4, 1024, 80, 64, 64, 256, torch.bfloat16)["dc_groups"][0] == (
        4, 1024, 10, 64)
    assert all(dtype == torch.float32 for _shape, dtype in shapes.values())
    fp32 = p_ssd.backward_scratch_shapes(4, 2048, 48, 64, 128, 64, torch.float32)
    assert list(fp32) == ["cum", "decay", "states", "cotangents", "state_dots", "ddt_x",
                          "dcum_k", "t", "dcum_q", "db_heads", "dc_heads", "da_chunks",
                          "cb_pairs"]
    assert fp32["db_heads"][0] == (4, 2048, 48, 128)
    assert fp32["cb_pairs"][0] == (4, 32, 1, 64, 64)
    assert p_ssd.backward_scratch_shapes(4, 1024, 80, 64, 64, 256, torch.float32)["cb_pairs"][0] == (
        4, 4, 10, 64, 64)  # 4 sub-tiles a chunk: 10 pairs J <= I
    assert p_ssd.backward_scratch_bytes(4, 2048, 48, 64, 128, 64, torch.float32) == 816_889_856
    assert p_ssd.backward_scratch_bytes(4, 1024, 80, 64, 64, 256, torch.float32) == 219_064_320
    assert p_ssd.backward_scratch_bytes(4, 1024, 80, 64, 64, 256, torch.bfloat16) == 69_642_240


def test_bf16_backward_scratch_at_mamba2_training_shape_is_below_the_cuda_core_design():
    """At mamba2-780m's training shape (B 4, S 2048, H 48, P 64, N 128,
    chunk 64) the bf16 backward's scratch is 462,471,168 bytes: the fp32
    states and cotangents (402.7 MB), dB and dC over 6 head groups (50.3
    MB) and the per-chunk terms, against the 816,889,856 bytes of the
    CUDA-core design (per-head dB and dC, C_I B_J^T pairs) that fp32 keeps."""
    bf16 = p_ssd.backward_scratch_bytes(4, 2048, 48, 64, 128, 64, torch.bfloat16)
    assert bf16 == 462_471_168
    assert bf16 < 816_889_856 == p_ssd.backward_scratch_bytes(4, 2048, 48, 64, 128, 64,
                                                              torch.float32)
