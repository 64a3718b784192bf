"""The port's Mamba2 SSD scan against the JAX package's.

On the CPU the kernel wrapper (``ops.ssd_scan``) runs its plain version,
``models/ssm.py::ssd_chunked``.  Both are held against three oracles of the
JAX package: the Pallas kernel ``repro.kernels.ssd_scan.ssd_scan`` in
interpret mode (as ``tests/test_kernels.py`` runs it), the sequential
recurrence ``repro.kernels.ref.ssd_sequential``, and steps of
``ssd_decode_step``, at the reference sweep's shapes plus ragged sequence
lengths.  Tolerances are the sweep's: fp32 2e-4 abs and rel (sums over the
chunk taken in other orders, exp of cumulative sums), bf16 5e-2 (one bf16
rounding of y, either side).  The CUDA kernel runs only on a card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.ssd_scan import ssd_scan as r_ssd_scan
from repro.models import ssm as r_ssm
from repro_torch.kernels import _build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import ssd_scan as p_ssd
from repro_torch.models import ssm as p_ssm

FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
# (batch, s, h, p, n, chunk): the reference sweep (tests/test_kernels.py),
# then ragged lengths at the smoke configs' and a model's (P, N).
SHAPES = [
    (2, 24, 2, 4, 8, 8), (2, 50, 3, 8, 4, 16), (2, 64, 4, 16, 16, 32),
    (2, 45, 2, 32, 16, 32), (1, 70, 2, 64, 128, 64),
]


def _inputs(b, s, h, p, n, seed):
    """x, B, C standard normal, dt = softplus(normal), a = -exp(normal): the
    sweep's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(port, ref, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_wrapper_matches_pallas_kernel_in_interpret_mode(b, s, h, p, n, chunk):
    arrays = _inputs(b, s, h, p, n, seed=s + h)
    before = p_ssd.ssd_scan.launches
    y, fin = p_ops.ssd_scan(*_t(*arrays), chunk=chunk)
    assert p_ssd.ssd_scan.launches == before  # the CPU runs the plain version
    assert y.shape == (b, s, h, p) and y.dtype == torch.float32
    assert fin.shape == (b, h, p, n) and fin.dtype == torch.float32
    ry, rfin = r_ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk, interpret=True)
    _close(y, ry)
    _close(fin, rfin)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_wrapper_matches_sequential_oracles(b, s, h, p, n, chunk):
    arrays = _inputs(b, s, h, p, n, seed=7 * s)
    y, fin = p_ops.ssd_scan(*_t(*arrays), chunk=chunk)
    ry, rfin = r_ref.ssd_sequential(*(jnp.asarray(a) for a in arrays))
    _close(y, ry)
    _close(fin, rfin)
    py, pfin = p_ref.ssd_sequential(*_t(*arrays))
    _close(y, py.numpy())
    _close(fin, pfin.numpy())


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_chunked_with_init_state_matches_reference_and_decode_steps(b, s, h, p, n, chunk):
    x, dt, a, bb, cc = _inputs(b, s, h, p, n, seed=11 * s)
    init = np.random.default_rng(s).standard_normal((b, h, p, n)).astype(np.float32)
    y, fin = p_ssm.ssd_chunked(*_t(x, dt, a, bb, cc), chunk, init_state=torch.as_tensor(init))
    jx = [jnp.asarray(v) for v in (x, dt, a, bb, cc)]
    ry, rfin = r_ssm.ssd_chunked(*jx, chunk, init_state=jnp.asarray(init))
    _close(y, ry)
    _close(fin, rfin)
    sy, sfin = r_ssm.ssd_sequential_ref(*jx, init_state=jnp.asarray(init))
    _close(y, sy)
    _close(fin, sfin)
    # The decode recurrence, one token at a time, from the same state.
    state = torch.as_tensor(init)
    tx, tdt, ta, tb, tc = _t(x, dt, a, bb, cc)
    for t in range(s):
        y_t, state = p_ssm.ssd_decode_step(state, tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t])
        _close(y_t, np.asarray(y[:, t]))
    _close(state, fin.numpy())


def test_decode_step_matches_reference():
    x, dt, a, bb, cc = _inputs(3, 1, 4, 8, 16, seed=3)
    state = np.random.default_rng(4).standard_normal((3, 4, 8, 16)).astype(np.float32)
    y, st = p_ssm.ssd_decode_step(*_t(state, x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0]))
    ry, rst = r_ssm.ssd_decode_step(*(jnp.asarray(v) for v in (
        state, x[:, 0], dt[:, 0], a, bb[:, 0], cc[:, 0])))
    _close(y, ry, dict(rtol=1e-5, atol=1e-5))
    _close(st, rst, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 32, 2, 4, 4, 8), (2, 45, 2, 32, 16, 32)])
def test_bf16_inputs_match_reference(b, s, h, p, n, chunk):
    """x, B, C in bf16 (dt and a fp32, as in the models): y in bf16 within
    5e-2 of the reference's chunked oracle on the same bf16 values."""
    x, dt, a, bb, cc = _inputs(b, s, h, p, n, seed=5)
    jx, jb, jc = (jnp.asarray(v, jnp.bfloat16) for v in (x, bb, cc))
    tx, tb, tc = (torch.as_tensor(np.array(v.astype(jnp.float32))).bfloat16()
                  for v in (jx, jb, jc))
    y, fin = p_ops.ssd_scan(tx, torch.as_tensor(dt), torch.as_tensor(a), tb, tc, chunk=chunk)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    ry, rfin = r_ref.ssd_scan_ref(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=chunk)
    _close(y, np.asarray(ry.astype(jnp.float32)), BF16)
    _close(fin, rfin)


def test_strided_views_of_one_conv_output():
    """x, B and C as the model makes them — views of one (B, S, di + 2N)
    tensor — give what contiguous copies give."""
    rng = np.random.default_rng(6)
    b, s, h, p, n = 2, 40, 2, 32, 16
    conv = torch.as_tensor(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    xin, bb, cc = torch.split(conv, [h * p, n, n], dim=-1)
    x = xin.reshape(b, s, h, p)
    assert not x.is_contiguous() and x.data_ptr() == conv.data_ptr()
    _x, dt, a, _b, _c = _inputs(b, s, h, p, n, seed=6)
    views = p_ops.ssd_scan(x, torch.as_tensor(dt), torch.as_tensor(a), bb, cc, chunk=32)
    copies = p_ops.ssd_scan(x.contiguous(), torch.as_tensor(dt), torch.as_tensor(a),
                            bb.contiguous(), cc.contiguous(), chunk=32)
    for got, want in zip(views, copies):
        assert torch.equal(got, want)


def test_plain_version_selects_above_the_diagonal():
    """Large |a dt| makes exp(cum_i - cum_j) overflow above the diagonal; a
    select (not a 0/1 product) keeps y finite, as in the reference."""
    x, dt, a, bb, cc = _inputs(1, 64, 2, 4, 4, seed=8)
    dt = dt * 50.0
    a = np.array([-16.0, -12.0], np.float32)
    y, fin = p_ops.ssd_scan(*_t(x, dt, a, bb, cc), chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    ry, rfin = r_ssm.ssd_sequential_ref(*(jnp.asarray(v) for v in (x, dt, a, bb, cc)))
    _close(y, ry)


def test_wrapper_refuses_a_device_mix():
    x, dt, a, bb, cc = _t(*_inputs(1, 8, 2, 4, 4, seed=9))
    with pytest.raises(ValueError, match="one device"):
        p_ops.ssd_scan(x, dt, a.to("meta"), bb, cc, chunk=8)


@pytest.mark.parametrize("p,n,chunk,ok", [
    (64, 128, 64, True), (64, 64, 256, True), (32, 16, 32, True), (4, 16, 8, True),
    (64, 32, 64, False), (48, 128, 64, False), (16, 16, 24, False), (16, 16, 512, False),
])
def test_kernel_shape_check(p, n, chunk, ok):
    """The kernel takes the listed (P, N) pairs and chunks; anything else is
    refused with a ValueError naming what it takes."""
    if ok:
        p_ssd.check_shape(p, n, chunk)
    else:
        with pytest.raises(ValueError, match="ssd_scan takes"):
            p_ssd.check_shape(p, n, chunk)


def test_kernel_source_lists_every_shape():
    """Every (P, N) the wrapper accepts has a template instance, the model
    shapes among them, and the library path is named by the source's hash."""
    src = (_build.CSRC / p_ssd.SOURCE).read_text()
    for p, n in p_ssd.SHAPES:
        assert f"X({p}, {n})" in src
    assert {(64, 128), (64, 64), (32, 16)} <= set(p_ssd.SHAPES)
    assert {64, 256, 32} <= set(p_ssd.CHUNKS)
    path = _build.library_path(p_ssd.SOURCE)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("ssd_scan-")


def test_kernel_refuses_cpu_tensors_directly():
    """The kernel route itself takes CUDA tensors only (the wrapper sends CPU
    tensors to the plain version before it)."""
    x, dt, a, bb, cc = _t(*_inputs(1, 8, 2, 4, 4, seed=10))
    with pytest.raises(ValueError, match="cuda"):
        p_ssd._check(x, dt, a, bb, cc, 8)


@pytest.mark.parametrize("batch,s,h,chunk,groups", [
    (4, 2048, 48, 64, (8, 8)),    # mamba2-780m's prefill
    (4, 1024, 80, 256, (2, 8)),   # zamba2-2.7b's prefill
    (2, 16, 48, 64, (1, 1)),      # the serve launcher's prompts: too few blocks at any group
    (2, 24, 2, 8, (1, 1)),
])
def test_head_groups_fill_the_card(batch, s, h, chunk, groups):
    """Heads per block of the bf16 chunk kernels: the most (at most 8) that
    still give each kernel TARGET_BLOCKS blocks, else 1; shapes alone."""
    assert p_ssd.head_groups(batch, s, h, chunk) == groups
    nc, nt = -(-s // chunk), -(-chunk // p_ssd.ROWS)
    for units, g in zip((batch * nc, batch * nc * nt), groups):
        assert 1 <= g <= p_ssd.MAX_GROUP
        if g > 1:
            assert units * -(-h // g) >= p_ssd.TARGET_BLOCKS
            assert units * -(-h // (2 * g)) < p_ssd.TARGET_BLOCKS or 2 * g > p_ssd.MAX_GROUP


def test_scratch_shapes_and_bytes():
    """At mamba2's prefill S_c alone is 4·32·48·64·128·4 B = 201 MB; the
    entering states are bf16 hi + lo with rows of N rounded up to 8."""
    sh = p_ssd.scratch_shapes(4, 2048, 48, 64, 128, 64)
    assert sh["states"] == ((4, 32, 48, 64, 128), torch.float32)
    assert sh["h_hi"] == sh["h_lo"] == ((4, 32, 48, 64, 128), torch.bfloat16)
    assert sh["cum"] == ((4, 32, 48, 64), torch.float32)
    assert sh["decay"] == ((4, 32, 48), torch.float32)
    states = 4 * 32 * 48 * 64 * 128 * 4
    assert states == 201_326_592
    assert p_ssd.scratch_bytes(4, 2048, 48, 64, 128, 64) == (
        2 * states + 4 * 32 * 48 * 64 * 4 + 4 * 32 * 48 * 4)
    ragged = p_ssd.scratch_shapes(2, 50, 3, 8, 4, 16)  # 4 chunks, the last ragged; N 4 -> 8
    assert ragged["states"][0] == (2, 4, 3, 8, 4)
    assert ragged["h_hi"][0] == (2, 4, 3, 8, 8)


def test_kernel_bytes_count_inputs_outputs_and_scratch():
    """Each kernel's bytes: its inputs read once and outputs written once,
    scratch included; together more than the SSD's own bound counts."""
    b, s, h, p, n, q = 4, 1024, 80, 64, 64, 256
    got = p_ssd.kernel_bytes(b, s, h, p, n, q)
    x, dt, bc = 2 * b * s * h * p, 4 * b * s * h, 2 * b * s * n
    nc = s // q
    states, entering = 4 * b * nc * h * p * n, 4 * b * nc * h * p * n
    cum, decay = 4 * b * nc * h * q, 4 * b * nc * h
    assert got == {
        "ssd_chunk_state_kernel": x + dt + 4 * h + bc + states + cum + decay,
        "ssd_state_pass_kernel": states + decay + entering + 4 * b * h * p * n,
        "ssd_chunk_scan_kernel": 2 * x + dt + 2 * bc + cum + entering,
    }
    own = 2 * x + 2 * bc + dt + 4 * h + 4 * b * h * p * n  # x, B, C, dt, a in; y, state out
    assert sum(got.values()) > own


def test_tma_ready_passes_aligned_views_and_pads_the_rest():
    """The model's views of one conv output go to TMA as they are; a view
    TMA cannot read (P = 4: an 8-byte head stride) is copied into rows
    padded to 8 elements, with the same values."""
    conv = torch.zeros(2, 16, 48 * 64 + 2 * 128, dtype=torch.bfloat16)
    xin, bb, cc = torch.split(conv, [48 * 64, 128, 128], dim=-1)
    x = xin.reshape(2, 16, 48, 64)
    assert conv.data_ptr() % 16 == 0  # PyTorch's allocators align to 64 bytes at least
    for t in (x, bb, cc):
        assert p_ssd.tma_ready(t) is t
    small = torch.arange(2 * 5 * 3 * 4, dtype=torch.float32).reshape(2, 5, 3, 4).bfloat16()
    ready = p_ssd.tma_ready(small)
    assert ready is not small and torch.equal(ready, small)
    assert ready.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in ready.stride()[:-1])


def test_kernel_source_has_the_three_bf16_kernels_and_its_header():
    """The bf16 path's three kernels are in the source, the shared Hopper
    header it includes exists, and the library's name follows the header."""
    src = (_build.CSRC / p_ssd.SOURCE).read_text()
    for name in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel",
                 "ssd_scan_kernel"):
        assert f"{name}(" in src
    assert '#include "hopper_tma_wgmma.cuh"' in src
    assert (_build.CSRC / "hopper_tma_wgmma.cuh").is_file()


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path(p_ssd.SOURCE)
    header = tmp_path / "hopper_tma_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(p_ssd.SOURCE) != before
