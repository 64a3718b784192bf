"""Tests of the port that need an NVIDIA GPU (marked ``cuda``; each skips
where ``torch.cuda.is_available()`` is false).  This file imports no JAX,
so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch._device import tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.core import TaskGraph, TaskGraphExecutor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
from repro_torch.kernels.ref import (
    flash_attention_bhsd_ref, flash_attention_ref, pearson_dissimilarity_ref, ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import SHAPES as SSD_PN, ssd_scan
from repro_torch.models.multitask import build_cnn_program, build_transformer_program
from repro_torch.models.registry import get_model
from repro_torch.serving import LMServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (300, 5000) and (200, 10001): several splits of F, F not a multiple of
# 256; 10001 % 4 != 0 takes the 4-byte copies.
@pytest.mark.parametrize("k,f", [(16, 64), (37, 100), (64, 300), (512, 1568), (130, 7), (256, 655360),
                                 (300, 5000), (200, 10001)])
def test_kernel_matches_plain_version(cuda, k, f):
    """fp32 to 1e-5 (the reference's tolerance), exactly symmetric."""
    feats = np.random.default_rng(k + f).standard_normal((k, f)).astype(np.float32)
    z = ops.standardize_rows(torch.as_tensor(feats, device=cuda)).contiguous()
    before = pearson_dissimilarity.launches
    out = pearson_dissimilarity(z)
    torch.cuda.synchronize()
    assert pearson_dissimilarity.launches == before + 1
    assert torch.equal(out, out.T)
    torch.testing.assert_close(out, pearson_dissimilarity_ref(z), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,f", [(256, 655360), (512, 1568)])
def test_kernel_is_bit_identical_across_calls(cuda, k, f):
    """No atomics and a fixed split order: two calls give the same bits."""
    feats = np.random.default_rng(k).standard_normal((k, f)).astype(np.float32)
    z = ops.standardize_rows(torch.as_tensor(feats, device=cuda)).contiguous()
    first = pearson_dissimilarity(z)
    second = pearson_dissimilarity(z)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros(8, 4, device=cuda)
    with pytest.raises(TypeError):
        pearson_dissimilarity(z.double())
    with pytest.raises(ValueError):
        pearson_dissimilarity(torch.zeros(4, 8, device=cuda).T)


def test_default_device_program_runs_on_the_card(cuda):
    graph = TaskGraph.fully_separate(2, 3)
    prog = build_cnn_program(graph, [4, 4], generator=torch.Generator().manual_seed(0))
    assert prog.device.type == "cuda"
    fused, _ = TaskGraphExecutor(prog).run_batch(torch.ones(4, 1, 28, 28, 1, device=cuda), [0, 1])
    blocks, _ = TaskGraphExecutor(prog, fused=False).run_batch(
        torch.ones(4, 1, 28, 28, 1, device=cuda), [0, 1])
    for t in (0, 1):
        assert fused[t].shape == (4, 1, 4)
        torch.testing.assert_close(fused[t], blocks[t], rtol=0, atol=1e-5)


def _randn(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.as_tensor(a, device=device).to(dtype)


# (BH, BHk, S, T, d, causal, window): ragged edges, GQA, windows, every head_dim.
FLASH_CASES = [
    (4, 4, 70, 70, 32, True, None),
    (4, 4, 48, 96, 64, True, None),
    (12, 2, 33, 33, 16, True, None),
    (4, 4, 70, 70, 32, True, 24),
    (4, 4, 70, 70, 32, False, 24),
    (2, 2, 40, 40, 128, False, None),
    (8, 2, 200, 200, 160, True, 24),
    (3, 1, 1, 65, 160, False, None),
    (8, 8, 130, 130, 80, True, None),
    # T of 3 or more KV tiles at d 80 and 160: the K/V ring turns over.
    (4, 4, 250, 250, 80, True, None),
    (4, 2, 200, 300, 80, False, None),
    (8, 2, 300, 300, 160, False, None),
    (4, 4, 260, 260, 160, True, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bhk,s,t,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda, bh, bhk, s, t, d, causal, window, dtype):
    """The reference sweep's tolerances: fp32 2e-5, bf16 2e-2."""
    q = _randn((bh, s, d), dtype, cuda, 1)
    k = _randn((bhk, t, d), dtype, cuda, 2)
    v = _randn((bhk, t, d), dtype, cuda, 3)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, causal, window).float(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("hq,hk", [(32, 8), (6, 1), (4, 4)])
def test_flash_kernel_model_layout(cuda, hq, hk):
    """Strided model layout (B, S, H, d), V a non-contiguous view as in the
    model (K and V share one projection), GQA without repeating K/V."""
    q = _randn((3, 130, hq, 160), torch.bfloat16, cuda, 4)
    kv = _randn((3, 130, 2, hk, 160), torch.bfloat16, cuda, 5)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = flash_attention.launches
    out = ops.flash_attention_bhsd(q, k, v, window=50)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_bhsd_ref(q, k, v, window=50).float(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("d,causal", [(160, False), (80, True)])
def test_flash_kernel_model_layout_ragged_kv(cuda, d, causal):
    """Model layout with T ragged (201 keys: 3 full tiles and 9 keys) and
    T != S, GQA 8/2, bf16."""
    q = _randn((2, 100, 8, d), torch.bfloat16, cuda, 6)
    k = _randn((2, 201, 2, d), torch.bfloat16, cuda, 7)
    v = _randn((2, 201, 2, d), torch.bfloat16, cuda, 8)
    out = ops.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), flash_attention_bhsd_ref(q, k, v, causal=causal).float(),
                               rtol=0, atol=2e-2)


def test_flash_kernel_copies_unaligned_bf16_views(cuda):
    """A bf16 view whose rows are not 16-byte aligned is copied, not refused."""
    buf = _randn((4, 70, 33), torch.bfloat16, cuda, 9)
    q, k, v = buf[..., 1:33], buf[..., :32], buf[..., 1:33]
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v).float(), rtol=0, atol=2e-2)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        z = torch.zeros(2, 8, 48, device=cuda)
        flash_attention(z, z, z)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(3, 8, 32, device=cuda), torch.zeros(3, 8, 32, device=cuda))
    with pytest.raises(ValueError):  # meta keeps the kernel's checks
        m = torch.empty(2, 8, 48, device="meta")
        flash_attention(m, m, m)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):  # rows 12.. keep no key: S >= T + window
        flash_attention(torch.zeros(2, 16, 32, device=cuda), q, q, causal=False, window=4)


def test_default_device_transformer_program_runs_on_the_card(cuda):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("mistral-nemo-12b"), num_layers=4)
    graph = TaskGraph.fully_separate(2, 3)
    prog = build_transformer_program(
        graph, cfg, [4, 4], 16, generator=torch.Generator(device=cuda).manual_seed(0))
    assert prog.device.type == "cuda"
    xs = torch.randint(0, 1000, (4, 1, 16), device=cuda)
    before = flash_attention.launches
    fused, stats = TaskGraphExecutor(prog).run_batch(xs, [0, 1])
    assert flash_attention.launches - before == stats.blocks_executed  # one layer a block
    blocks, _ = TaskGraphExecutor(prog, fused=False).run_batch(xs, [0, 1])
    for t in (0, 1):
        assert fused[t].shape == (4, 1, 4)
        torch.testing.assert_close(fused[t], blocks[t], rtol=0, atol=1e-5)


# (batch, s, h, p, n, chunk): the model shapes (mamba2-780m, zamba2-2.7b) at
# short lengths, a ragged length, the smoke configs' and the reference
# sweep's shapes.
SSD_CASES = [
    (2, 300, 4, 64, 128, 64), (2, 600, 3, 64, 64, 256), (2, 200, 4, 64, 128, 64),
    (2, 45, 4, 32, 16, 32), (2, 24, 2, 4, 8, 8), (2, 50, 3, 8, 4, 16), (2, 64, 4, 16, 16, 32),
]


def _ssd_inputs(b, s, h, p, n, dtype, device, seed):
    """x, B and C as views of one conv output, as the model makes them;
    dt = softplus(normal) and a = -exp(normal) in fp32."""
    rng = np.random.default_rng(seed)
    conv = _randn((b, s, h * p + 2 * n), dtype, device, seed)
    xin, bb, cc = torch.split(conv, [h * p, n, n], dim=-1)
    dt = torch.nn.functional.softplus(
        torch.as_tensor(rng.standard_normal((b, s, h)).astype(np.float32), device=device))
    a = -torch.exp(torch.as_tensor(rng.standard_normal(h).astype(np.float32), device=device))
    return xin.reshape(b, s, h, p), dt, a, bb, cc


def _ssd_float64(x, dt, a, bb, cc):
    """The sequential recurrence in float64 on the CPU: exact enough to
    measure an fp32 implementation's own rounding error."""
    x, dt, a, bb, cc = (t.double().cpu() for t in (x, dt, a, bb, cc))
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], bb.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        upd = (dt[:, t, :, None] * x[:, t])[..., None] * bb[:, t, None, None, :]
        state = state * torch.exp(dt[:, t] * a)[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, cc[:, t]))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_kernel_matches_plain_version(cuda, b, s, h, p, n, chunk, dtype):
    """y and the final state against the plain version: from bf16 inputs
    within 5e-2 abs and rel; in fp32 within 2e-4 abs and rel (the reference
    sweep's), plus where the plain version itself is off the float64
    recurrence.  Both take the chunk's cumulative sum of dt * a in fp32, in
    other orders; it rounds at |cum| 2^-24, which at chunk 256 (|cum| in the
    hundreds) costs up to ~6e-4 on outputs of ~170 and so can exceed 2e-4 on
    an output that cancels to near 0."""
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, dtype, cuda, seed=s + n)
    before = ssd_scan.launches
    y, fin = ops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == x.shape and fin.dtype == torch.float32
    ry, rfin = ssd_scan_ref(x, dt, a, bb, cc, chunk)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), ry.float(), rtol=5e-2, atol=5e-2)
        torch.testing.assert_close(fin, rfin, rtol=5e-2, atol=5e-2)
        return
    exact = _ssd_float64(x, dt, a, bb, cc)
    for got, plain, truth in zip((y, fin), (ry, rfin), exact):
        got, plain = got.double().cpu(), plain.double().cpu()
        bound = 2e-4 * (1 + plain.abs()) + (plain - truth).abs()
        assert bool(((got - plain).abs() <= bound).all()), float(((got - plain).abs() - bound).max())


# bf16 at full model width: shorter than one chunk (the serve launcher's
# 16-token prompts), ragged over 4 chunks of 256, and 32 chunks of 64.
SSD_BF16_MODEL_CASES = [
    (2, 16, 48, 64, 128, 64), (1, 1000, 80, 64, 64, 256), (2, 2048, 48, 64, 128, 64),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BF16_MODEL_CASES)
def test_ssd_bf16_kernel_at_model_width(cuda, b, s, h, p, n, chunk):
    """The three bf16 kernels at the models' widths: y and the final state
    within 5e-2 abs and rel of the plain version, one launch counted."""
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda, seed=s + h)
    before = ssd_scan.launches
    y, fin = ops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and fin.dtype == torch.float32
    ry, rfin = ssd_scan_ref(x, dt, a, bb, cc, chunk)
    torch.testing.assert_close(y.float(), ry.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(fin, rfin, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(4, 2048, 48, 64, 128, 64), (4, 1024, 80, 64, 64, 256)])
def test_ssd_bf16_kernel_is_bit_identical_across_calls(cuda, b, s, h, p, n, chunk):
    """No atomics and fixed summation orders: two calls at the model
    prefills' shapes give the same bits in y and the final state."""
    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda, seed=h)
    first = ops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    second = ops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
    torch.cuda.synchronize()
    for one, two in zip(first, second):
        assert torch.equal(one, two)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a, bb, cc = _ssd_inputs(1, 16, 2, 16, 16, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="ssd_scan takes"):  # P = 8 with N = 32
        ops.ssd_scan(torch.zeros(1, 16, 2, 8, device=cuda), dt, a,
                     torch.zeros(1, 16, 32, device=cuda), torch.zeros(1, 16, 32, device=cuda), 16)
    with pytest.raises(ValueError, match="ssd_scan takes"):  # P = 48
        ops.ssd_scan(torch.zeros(1, 16, 2, 48, device=cuda), dt, a, bb, cc, 16)
    with pytest.raises(ValueError, match="ssd_scan takes"):  # chunk 24
        ops.ssd_scan(x, dt, a, bb, cc, 24)
    with pytest.raises(ValueError, match="one device"):
        ops.ssd_scan(x, dt.cpu(), a, bb, cc, 16)
    with pytest.raises(ValueError, match="one device"):
        ops.ssd_scan(x.cpu(), dt, a, bb, cc, 16)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.bfloat16(), a, bb, cc, 16)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.bfloat16(), dt, a, bb, cc, 16)
    with pytest.raises(TypeError):
        ops.ssd_scan(x.half(), dt, a, bb.half(), cc.half(), 16)


@pytest.mark.parametrize("arch,launches", [("mamba2-780m", (4, 0)), ("zamba2-2.7b", (4, 2))])
def test_default_device_lm_server_runs_each_family_on_the_card(cuda, arch, launches):
    """Smoke configs at 4 layers on the default device: one prefill launches
    the SSD kernel once per Mamba2 layer (and flash once per shared-attention
    invocation); decode launches neither; tokens equal the CPU run's."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    assert params["embed"]["embedding"].device.type == "cuda"
    prompts = np.random.default_rng(0).integers(0, 1000, (2, 70)).astype(np.int32)
    before = (ssd_scan.launches, flash_attention.launches)
    out = LMServer(model, params).generate(prompts, 6)
    torch.cuda.synchronize()
    assert (ssd_scan.launches - before[0], flash_attention.launches - before[1]) == launches
    ref = LMServer(model, tree_map(lambda t: t.cpu(), params)).generate(prompts, 6)
    np.testing.assert_array_equal(out, ref)


def test_session_recovers_from_scripted_faults_on_the_card(cuda):
    """A LeNet-5 engine on the card serves a session under scripted faults:
    one group retried on the primary path, one served by the unfused rung;
    counters equal the prediction and outputs the fault-free run's to 1e-5."""
    from repro_torch.core import MSP430
    from repro_torch.serving import (
        FaultInjector, MultitaskEngine, MultitaskRequest, RequestGroupScheduler,
        RetryPolicy, WindowPolicy,
    )

    graph = TaskGraph.from_groups([
        [[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0, 1], [2, 3]], [[0], [1], [2], [3]],
    ])
    prog = build_cnn_program(graph, [4] * 4, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    subsets = (None, (0, 1), (2, 3), (1,))
    reqs = [MultitaskRequest(x=rng.standard_normal((1, 28, 28, 1)).astype(np.float32),
                             tasks=subsets[i % 4]) for i in range(12)]
    clean = MultitaskEngine(prog, hw=MSP430).serve_batch(reqs)

    engine = MultitaskEngine(
        prog, hw=MSP430, scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)),
        fault_injector=FaultInjector(script={"plan": {1, 2}, "dispatch": {6}}),
    )
    now = [0.0]
    session = engine.session(policy=WindowPolicy(max_wait=0.2, max_group_size=4),
                             clock=lambda: now[0], sleep=lambda s: None,
                             retry=RetryPolicy(max_retries=1))
    futures = []
    for r in reqs:
        now[0] += 0.1
        futures.append(session.submit(r))
        session.step()
    session.drain()
    torch.cuda.synchronize()
    responses = [f.result() for f in futures]
    assert session.stats == session.predicted
    assert any(r.degraded == "unfused" for r in responses)
    assert any(r.retries > 0 and r.degraded is None for r in responses)
    assert engine.executor.fused
    for got, want in zip(responses, clean):
        assert set(got.outputs) == set(want.outputs)
        for t in want.outputs:
            assert got.outputs[t].device.type == "cuda"
            torch.testing.assert_close(got.outputs[t], want.outputs[t], rtol=0, atol=1e-5)


def test_moe_mlp_bf16_is_bit_identical_and_close_to_the_cpu(cuda):
    """The MoE layer in bf16 on the card: two calls give the same bits (the
    combine gathers each token's slots in a fixed order, no atomic
    scatter), and the outputs are within 5e-2 of the same layer on the CPU;
    pooled decode-sized groups and one group per row alike."""
    import dataclasses

    from repro_torch.models.moe import init_moe_mlp, moe_mlp

    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = init_moe_mlp(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    on_card = tree_map(lambda t: t.to(cuda), params)
    for b, s in ((4, 1), (3, 16), (2, 70)):
        x = _randn((b, s, cfg.d_model), torch.bfloat16, "cpu", b * s)
        first, aux1 = moe_mlp(on_card, x.to(cuda), cfg)
        second, aux2 = moe_mlp(on_card, x.to(cuda), cfg)
        torch.cuda.synchronize()
        assert first.dtype == torch.bfloat16 and first.shape == x.shape
        assert torch.equal(first, second) and torch.equal(aux1, aux2)
        cpu, aux_cpu = moe_mlp(params, x, cfg)
        torch.testing.assert_close(first.cpu().float(), cpu.float(), rtol=5e-2, atol=5e-2)
        torch.testing.assert_close(aux1.cpu(), aux_cpu, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_whisper_padded_keys(cuda, dtype):
    """Non-causal attention of 40 queries over 24 keys zero-padded to 64, as
    the enc-dec's encoder and cross-attention feed the kernel (4/4 heads,
    d 64): the padded keys count as real ones, as in the plain version."""
    from repro_torch.models.encdec import reference_keys

    q = _randn((2, 40, 4, 64), dtype, cuda, 10)
    k, v = reference_keys(_randn((2, 24, 4, 64), dtype, cuda, 11),
                          _randn((2, 24, 4, 64), dtype, cuda, 12), 64, chunked=True, causal=False)
    assert k.shape[1] == 64
    before = flash_attention.launches
    out = ops.flash_attention_bhsd(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    ref = flash_attention_bhsd_ref(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


def test_whisper_decode_matches_forward_on_the_card(cuda):
    """Whisper's smoke config on the card: one prefill launches flash once
    per encoder layer and twice per decoder layer; one decode step after it
    launches none and equals ``forward``'s next position to 3e-3.  100
    frames: past the 64-key chunk, where the reference's prefill pads the
    cross-attention's keys as its forward does."""
    from repro_torch.serving.engine import _grow_cache

    cfg = get_smoke_config("whisper-medium")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 100, cfg.enc_inputs)).astype(np.float32)
    toks = torch.as_tensor(rng.integers(0, 1000, (2, 20)), device=cuda)
    full, _ = model.forward(params, {"features": feats, "tokens": toks})
    before = flash_attention.launches
    last, cache = model.prefill(params, {"features": feats, "tokens": toks[:, :19]})
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.enc_layers + 2 * cfg.num_layers
    torch.testing.assert_close(last, full[:, 18], rtol=3e-3, atol=3e-3)
    cache = _grow_cache(model, cache, 20, 19)
    before = flash_attention.launches
    step, _ = model.decode_step(params, toks[:, 19], cache, 19)
    torch.cuda.synchronize()
    assert flash_attention.launches == before
    torch.testing.assert_close(step, full[:, 19], rtol=3e-3, atol=3e-3)


# --------------------------------------------------------------------------
# Weight streaming and the journal on the card
# --------------------------------------------------------------------------

def _streamed_program(cuda, dim=2048):
    """Four tasks over depth-3 blocks of (dim, dim) fp32 weights (16 MB a
    node at 2048): copies long enough to still be in flight when the host
    cancels them."""
    from repro_torch.core import BlockCost, MultitaskProgram

    graph = TaskGraph.from_groups([[[0, 1, 2, 3]], [[0, 1], [2, 3]], [[0], [1], [2], [3]]])
    gen = torch.Generator(device=cuda).manual_seed(0)
    nodes = {n: torch.randn(dim, dim, device=cuda, generator=gen) / dim ** 0.5
             for n in graph.nodes()}
    heads = [torch.randn(dim, 3, device=cuda, generator=gen) for _ in range(4)]
    return MultitaskProgram(
        graph, [lambda p, x: torch.tanh(x @ p)] * graph.depth, nodes,
        [lambda p, x: x @ p] * 4, heads,
        [BlockCost(weight_bytes=4.0 * dim * dim, flops=2.0 * dim * dim)] * graph.depth)


def test_streamer_side_stream_cancel_and_restage_never_corrupts(cuda):
    """100 cycles of stage, cancel while the copies are in flight, restage
    another batch and run on it: every committed copy equals its source bit
    for bit, and the outputs equal the synchronous executor's."""
    from repro_torch.core import GraphCostModel, MSP430

    prog = _streamed_program(cuda)
    cm = GraphCostModel(prog.graph, prog.block_costs, MSP430)
    xs = torch.randn(4, 2048, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    sync = {tuple(o): TaskGraphExecutor(prog).run_batch(xs, o)[0]
            for o in ([0, 1], [2, 3], [1, 3])}
    ex = TaskGraphExecutor(prog)
    ex.streamer.prepare()
    assert all(h.is_pinned() for h in ex.streamer._host.values())
    orders = list(sync)
    for cycle in range(100):
        ex.reset()
        first, second = orders[cycle % 3], orders[(cycle + 1) % 3]
        ex.streamer.stage(cm.plan_loads(first, ex.residency_state()))
        if cycle % 2:
            ex.streamer.cancel()
        ex.streamer.stage(cm.plan_loads(second, ex.residency_state()))
        out, stats = ex.run_batch(xs, list(second))
        assert stats.prefetched_bytes == stats.weight_bytes_loaded > 0
        for node, copy in ex._streamed_node.items():
            assert torch.equal(copy, prog.node_params[node])
        for t, y in sync[second].items():
            assert torch.equal(out[t], y)
    torch.cuda.synchronize()
    nbytes, start, end = ex.streamer.copy_log[-1]
    assert nbytes > 0 and start.elapsed_time(end) > 0


def test_streamed_session_matches_synchronous_on_the_card(cuda):
    """A streamed session on the card: counters exact, outputs bit-identical
    to the synchronous session's."""
    from repro_torch.core import MSP430
    from repro_torch.serving import (
        EnginePolicy, MultitaskEngine, MultitaskRequest, RequestGroupScheduler,
    )

    prog = _streamed_program(cuda, dim=512)
    rng = np.random.default_rng(2)
    subsets = ((0, 1), (2, 3), (0,), (1, 3), None)
    reqs = [MultitaskRequest(x=torch.as_tensor(rng.standard_normal(512).astype(np.float32)),
                             tasks=subsets[i % 5]) for i in range(12)]
    results = []
    for streaming in (False, True):
        engine = MultitaskEngine(prog, hw=MSP430, policy=EnginePolicy(streaming=streaming),
                                 scheduler=RequestGroupScheduler(batch_shapes=(1, 2, 4)))
        session = engine.session()
        futures = [session.submit(r) for r in reqs]
        session.drain()
        assert session.stats == session.predicted
        results.append((session, [f.result() for f in futures]))
    (sync, sync_r), (strm, strm_r) = results
    assert strm.stats.prefetched_bytes > 0 and strm.prefetches_issued > 0
    for a, b in zip(sync_r, strm_r):
        for t in a.outputs:
            assert torch.equal(a.outputs[t], b.outputs[t])


def test_bf16_journal_round_trip_on_the_card(cuda, tmp_path):
    """A bf16 activation on the card goes through the file journal and
    restores bit-exactly, in bf16, on the executor's device."""
    from repro_torch.core.executor import ActivationCheckpoint
    from repro_torch.serving import FileJournalStore, Journal

    prog = _streamed_program(cuda, dim=64)
    value = torch.randn(4, 64, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3)).to(torch.bfloat16)
    node = prog.graph.path(2)[1]
    path = str(tmp_path / "journal.jsonl")
    journal = Journal(FileJournalStore(path))
    journal.group_begin(0, [0], [2], 1)
    journal.checkpoint(0, 0, 2, 1, node, value, tuple(value.shape))
    state = Journal(FileJournalStore(path)).replay()
    ex = TaskGraphExecutor(prog)
    ex.restore_activation(ActivationCheckpoint(
        depth=int(state.checkpoint["depth"]), node=state.checkpoint_node(),
        value=state.checkpoint["value"], act_shape=tuple(state.checkpoint["act_shape"])))
    back = ex.activation_checkpoint(2).value
    assert back.device.type == "cuda" and back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), value.view(torch.int16))


def _on(program, device):
    """``program`` with its params and heads moved to ``device``."""
    import dataclasses

    return dataclasses.replace(
        program,
        node_params={n: tree_map(lambda t: t.to(device), p)
                     for n, p in program.node_params.items()},
        head_params=[tree_map(lambda t: t.to(device), p) for p in program.head_params],
    )


def _adaptive_programs(kind):
    """A CPU program of ``kind`` ("toy": ``tanh(x @ W)`` blocks on 8 features,
    scan suffixes; "transformer": a 3-layer fp32 smoke mistral-nemo), its
    inputs, and a threshold between two requests' block-1 confidences."""
    import dataclasses

    from repro_torch.adaptive import mean_abs_confidence
    from repro_torch.core import BlockCost, MultitaskProgram

    rng = np.random.default_rng(0)
    graph = TaskGraph.from_groups([[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]]])
    if kind == "toy":
        nodes = {n: torch.tensor(rng.normal(size=(8, 8)), dtype=torch.float32)
                 for n in graph.nodes()}
        heads = [torch.tensor(rng.normal(size=(8, 3)), dtype=torch.float32) for _ in range(3)]
        prog = MultitaskProgram(graph, [lambda p, x: torch.tanh(x @ p)] * 3, nodes,
                                [lambda p, x: x @ p] * 3, heads,
                                [BlockCost(100.0, 10.0)] * 3)
        scale = np.where(np.arange(8) % 3 == 0, 0.2, 2.0)[:, None]
        return prog, torch.tensor(rng.normal(size=(8, 8)) * scale, dtype=torch.float32), 0.5
    cfg = dataclasses.replace(get_smoke_config("mistral-nemo-12b"), num_layers=3,
                              dtype="float32", param_dtype="float32")
    prog = build_transformer_program(graph, cfg, [4, 3, 5], 16,
                                     generator=torch.Generator().manual_seed(0), device="cpu")
    xs = torch.tensor(rng.integers(0, 1000, (8, 1, 16)), dtype=torch.int32)
    h = prog.block_fns[0](prog.node_params[graph.path(0)[0]], xs.flatten(0, 1))
    conf = torch.vmap(mean_abs_confidence)(h.unflatten(0, (8, 1))).sort().values
    return prog, xs, float(conf[3] + conf[4]) / 2  # halfway: no row near it


@pytest.mark.parametrize("kind", ["toy", "transformer"])
@pytest.mark.parametrize("mode", ["early_exit", "per_block"])
def test_masked_fused_suffix_matches_the_cpu(cuda, kind, mode):
    """fp32: the masked fused suffix on the card gates exactly as on the CPU
    (equal traces and counters), outputs within 1e-5 (2e-4 through the
    transformer), and the thresholds live on the card."""
    from repro_torch.adaptive import BlockGater

    prog, xs, thr = _adaptive_programs(kind)
    order = [0, 2, 1]
    cpu = TaskGraphExecutor(prog, gater=BlockGater(mode=mode, threshold=thr))
    card = TaskGraphExecutor(_on(prog, cuda), gater=BlockGater(mode=mode, threshold=thr))
    want, s_cpu = cpu.run_batch(xs, order)
    got, s_card = card.run_batch(xs.to(cuda), order)
    assert card.last_trace == cpu.last_trace
    assert s_card == s_cpu and s_card.block_rows_gated > 0
    for key, (values, thrs) in card._thresholds.items():
        assert key[2].type == "cuda" and thrs.device.type == "cuda"
    tol = 1e-5 if kind == "toy" else 2e-4
    for t in order:
        torch.testing.assert_close(got[t].cpu(), want[t], rtol=0, atol=tol)


def test_adaptive_floor_is_bit_identical_to_ungated_on_the_card(cuda):
    """bf16 smoke transformer on the card: ``threshold=inf`` gives the ungated
    executor's outputs bit for bit, with the same flash launches."""
    import dataclasses

    from repro_torch.adaptive import BlockGater

    cfg = dataclasses.replace(get_smoke_config("mistral-nemo-12b"), num_layers=4)
    graph = TaskGraph.from_groups([[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]]])
    prog = build_transformer_program(
        graph, cfg, [4, 3, 5], 16, generator=torch.Generator(device=cuda).manual_seed(0))
    xs = torch.randint(0, 1000, (4, 1, 16), device=cuda)
    launches = []
    outs = []
    for gater in (None, BlockGater()):
        before = flash_attention.launches
        out, stats = TaskGraphExecutor(prog, gater=gater).run_batch(xs, [0, 2, 1])
        torch.cuda.synchronize()
        launches.append(flash_attention.launches - before)
        outs.append(out)
    assert launches[0] == launches[1] > 0
    for t in (0, 1, 2):
        assert torch.equal(outs[0][t], outs[1][t])


def test_threshold_changes_build_no_program_on_the_card(cuda):
    """Three thresholds in a row: no new suffix program, one threshold tensor
    per ``(start, stop)`` on the card, refilled in place."""
    from repro_torch.adaptive import BlockGater

    prog, xs, thr = _adaptive_programs("toy")
    ex = TaskGraphExecutor(_on(prog, cuda), gater=BlockGater(threshold=thr))
    xs = xs.to(cuda)
    ex.run_batch(xs, [0, 1, 2])
    programs = len(ex._compiled_fused)
    tensors = {k: id(t) for k, (_v, t) in ex._thresholds.items()}
    for scale in (0.5, 2.0, 1.0):
        ex.gater.threshold = thr * scale
        ex.run_batch(xs, [0, 1, 2])
        assert len(ex._compiled_fused) == programs
        assert {k: id(t) for k, (_v, t) in ex._thresholds.items()} == tensors
        for (start, stop, device), (values, thrs) in ex._thresholds.items():
            assert thrs.device.type == "cuda"
            assert torch.equal(thrs.cpu(), torch.tensor(values, dtype=torch.float32))


# --------------------------------------------------------------------------
# The flash backward and the kernels' grad guards
# --------------------------------------------------------------------------

# Relative to each gradient's largest |value|: fp32 inputs on the CUDA
# cores, fp32 sums in another order; bf16 inputs, each gradient rounded to
# bf16 once.
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _flash_grads(q, k, v, d_o, causal, window):
    """(o, dq, dk, dv) through the kernel under autograd (flat or model layout)."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    attend = flash_attention if q.dim() == 3 else ops.flash_attention_bhsd
    o = attend(q, k, v, causal=causal, window=window)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), d_o))


def _plain_grads(q, k, v, d_o, causal, window):
    """Autograd through the plain version in fp32 (flat or model layout)."""
    q, k, v = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    attend = flash_attention_ref if q.dim() == 3 else flash_attention_bhsd_ref
    return torch.autograd.grad(attend(q, k, v, causal, window), (q, k, v), d_o.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,bhk,s,t,d,causal,window", FLASH_CASES)
def test_flash_backward_matches_plain_version(cuda, bh, bhk, s, t, d, causal, window, dtype):
    """dQ, dK and dV against the plain backward on the forward's own output
    and logsumexp, and against autograd through the plain forward; one
    forward and one backward launch counted."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_lse_ref

    q, k, v = (_randn(sh, dtype, cuda, i) for i, sh in
               enumerate(((bh, s, d), (bhk, t, d), (bhk, t, d)), 11))
    d_o = _randn((bh, s, d), dtype, cuda, 14)
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    o, dq, dk, dv = _flash_grads(q, k, v, d_o, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention.backward_launches == bwd + 1
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    lse = flash_attention_lse_ref(q, k, causal, window)
    tol = FLASH_BWD_TOL[dtype]
    for got, want in zip((dq, dk, dv), flash_attention_bwd_ref(q, k, v, o, d_o, lse, causal,
                                                                window)):
        assert _rel_err(got, want) <= tol
    for got, want in zip((dq, dk, dv), _plain_grads(q, k, v, d_o, causal, window)):
        assert _rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 160])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_backward_model_layout_every_head_dim(cuda, d, causal, window, dtype):
    """GQA 8/2 on the model layout, K and V views of one projection as in the
    model, at every head_dim the kernels take."""
    q = _randn((2, 150, 8, d), dtype, cuda, 21)
    kv = _randn((2, 150, 2, 2, d), dtype, cuda, 22)
    k, v = kv[:, :, 0], kv[:, :, 1]
    d_o = _randn((2, 150, 8, d), dtype, cuda, 23)
    _o, dq, dk, dv = _flash_grads(q, k, v, d_o, causal, window)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), _plain_grads(q, k, v, d_o, causal, window)):
        assert _rel_err(got, want) <= FLASH_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_bit_identical_across_calls(cuda, dtype):
    """No atomics: dK and dV summed over a GQA group in one fixed order."""
    q = _randn((4, 512, 32, 160), dtype, cuda, 31)
    k = _randn((4, 512, 8, 160), dtype, cuda, 32)
    v = _randn((4, 512, 8, 160), dtype, cuda, 33)
    d_o = _randn((4, 512, 32, 160), dtype, cuda, 34)
    first = _flash_grads(q, k, v, d_o, True, None)
    second = _flash_grads(q, k, v, d_o, True, None)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,hq,hk,d,window", [(200, 32, 8, 160, None), (200, 8, 2, 80, 48)])
def test_flash_backward_bf16_ragged_tiles_and_window_edges(cuda, s, hq, hk, d, window):
    """The tensor-core backward where its tiles meet the edges: GQA 32/8 at
    head_dim 160 over 200 queries and keys (ragged against 64-row tiles),
    and a causal window of 48 whose edge crosses the tiles at head_dim 80.
    Against autograd of the plain version, bit-identical across calls."""
    q = _randn((2, s, hq, d), torch.bfloat16, cuda, 61)
    k = _randn((2, s, hk, d), torch.bfloat16, cuda, 62)
    v = _randn((2, s, hk, d), torch.bfloat16, cuda, 63)
    d_o = _randn((2, s, hq, d), torch.bfloat16, cuda, 64)
    first = _flash_grads(q, k, v, d_o, True, window)
    second = _flash_grads(q, k, v, d_o, True, window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for got, want in zip(first[1:], _plain_grads(q, k, v, d_o, True, window)):
        assert _rel_err(got, want) <= FLASH_BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_is_unchanged_by_the_logsumexp(cuda, dtype):
    """Inference asks for no logsumexp: its output is bit-identical to the
    forward that writes one (under autograd), which equals the plain
    version's logsumexp."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_lse_ref

    q = _randn((2, 300, 8, 128), dtype, cuda, 41)
    k = _randn((2, 300, 2, 128), dtype, cuda, 42)
    v = _randn((2, 300, 2, 128), dtype, cuda, 43)
    g = fa._geometry(q, k, True, 100)
    plain, none = fa._forward(q, k, v, g, with_lse=False)
    with_lse, lse = fa._forward(q, k, v, g, with_lse=True)
    graded = ops.flash_attention_bhsd(q.requires_grad_(True), k, v, window=100)
    torch.cuda.synchronize()
    assert none is None
    assert torch.equal(plain, with_lse) and torch.equal(plain, graded.detach())
    want = flash_attention_lse_ref(q.detach().transpose(1, 2).reshape(16, 300, 128),
                                   k.transpose(1, 2).reshape(4, 300, 128), True, 100)
    torch.testing.assert_close(lse.reshape(16, 300), want, rtol=0, atol=1e-5)


def test_flash_function_agrees_with_autograd_of_the_plain_version(cuda):
    """``FlashAttentionFunction``'s gradients in fp32 at a small shape
    against autograd through the plain version, flowing on into an input
    and a projection (no detached output): within 1e-5 of each gradient's
    largest |value|, as the kernel's own tests.  The projection is scaled
    by 1 / sqrt(fan-in), as the models initialise theirs, so the scores
    stay unit-scale."""
    from repro_torch.kernels.flash_attention import FlashAttentionFunction, _geometry

    x = _randn((2, 40, 32), torch.float32, cuda, 51).requires_grad_(True)
    w = (_randn((32, 3, 4, 16), torch.float32, cuda, 52) / 32 ** 0.5).requires_grad_(True)

    def loss_of(attend):
        q, k, v = torch.einsum("bsd,dphk->pbshk", x, w).unbind(0)
        out = attend(q.contiguous(), k.contiguous(), v.contiguous())
        return (out * out).sum()

    gx, gw = torch.autograd.grad(
        loss_of(lambda q, k, v: FlashAttentionFunction.apply(q, k, v,
                                                             _geometry(q, k, True, None))),
        (x, w))
    gx_ref, gw_ref = torch.autograd.grad(
        loss_of(lambda q, k, v: flash_attention_bhsd_ref(q, k, v, True, None)), (x, w))
    assert _rel_err(gx, gx_ref) <= 1e-5
    assert _rel_err(gw, gw_ref) <= 1e-5


def test_pearson_refuses_grad_on_the_card(cuda):
    """Pearson has no backward kernel (the reference never differentiates
    it): with grad enabled and an input that requires grad it raises
    instead of returning a tensor cut off from autograd; without grad it
    runs."""
    z = ops.standardize_rows(_randn((16, 64), torch.float32, cuda, 64)).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        pearson_dissimilarity(z)
    assert pearson_dissimilarity(z.detach()).shape == (16, 16)


# The SSD backward: each gradient's max abs error over its largest |value|,
# fp32 (sums in other orders) and from bf16 inputs (dx, dB, dC rounded once).
SSD_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_BWD_MODEL_CASES = [(4, 2048, 48, 64, 128, 64), (4, 1024, 80, 64, 64, 256)]


def _ssd_bwd_check(cuda, b, s, h, p, n, chunk, dtype, with_final, seed):
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import backward_scratch_bytes, ssd_scan_backward

    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, dtype, cuda, seed=seed)
    dy = _randn((b, s, h, p), dtype, cuda, seed + 1)
    d_final = _randn((b, h, p, n), torch.float32, cuda, seed + 2) if with_final else None
    before = ssd_scan.backward_launches
    got = ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, chunk)
    again = ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, chunk)
    torch.cuda.synchronize()
    assert ssd_scan.backward_launches == before + 2
    # The one allocation holds every buffer, each rounded up to 256 bytes.
    layout = backward_scratch_bytes(b, s, h, p, n, chunk, dtype)
    assert layout <= ssd_scan.backward_scratch_allocated < layout + 256 * 13
    assert all(torch.equal(one, two) for one, two in zip(got, again))
    want = ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, d_final, chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel_err(g, w) <= SSD_BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_backward_matches_plain_version(cuda, b, s, h, p, n, chunk, dtype):
    """The backward kernels against ``ssd_scan_bwd_ref`` at the SSD's test
    shapes (chunks 8-256, ragged lengths), with a cotangent of the final
    state, bit-identical across two calls."""
    _ssd_bwd_check(cuda, b, s, h, p, n, chunk, dtype, True, seed=s + n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BWD_MODEL_CASES)
def test_ssd_backward_at_the_model_shapes(cuda, b, s, h, p, n, chunk, dtype):
    """mamba2-780m's and zamba2-2.7b's training shapes, no final-state
    cotangent (the models discard the final state in training)."""
    _ssd_bwd_check(cuda, b, s, h, p, n, chunk, dtype, False, seed=h)


def _swizzle(r, c):
    """Byte offset of element (r, c) of a 64-row bf16 tile in 128-byte-swizzle
    atoms of 64 columns, as TMA writes it."""
    return (c // 64) * 8192 + r * 128 + ((((c % 64) // 8) ^ (r % 8)) << 4) + (c % 8) * 2


def test_swizzle_offsets_at_the_kernels_index_patterns(cuda, tmp_path):
    """``hopper::tile_off`` compiled as the kernels are (``_build``'s nvcc
    flags) and run on the card, at the three index patterns the kernels
    read and write their swizzled tiles with: the row dot over an
    accumulator's columns (which an earlier form of the offset was
    miscompiled at), the chunk kernels' A fragments and the state staging."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build

    source = Path(__file__).parent / "cuda" / "swizzle_offsets.cu"
    lib = tmp_path / "swizzle_offsets.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                    str(source)], check=True, capture_output=True)
    out = torch.full((3, 128, 64), -1, dtype=torch.int32, device=cuda)
    assert ctypes.CDLL(str(lib)).swizzle_offsets(ctypes.c_void_p(out.data_ptr())) == 0
    got = out.cpu().numpy()
    want = np.full((3, 128, 64), -1, dtype=np.int32)
    for t in range(128):
        warp, g, qd = t // 32, (t % 32) // 4, t % 4
        for rr in range(2):
            for i in range(16):
                for e in range(2):
                    want[0, t, (rr * 16 + i) * 2 + e] = _swizzle(16 * warp + g + 8 * rr,
                                                                 8 * i + 2 * qd + e)
        for kk in range(4):
            for half in range(2):
                for e in range(2):
                    for rr in range(2):
                        want[1, t, ((kk * 2 + half) * 2 + e) * 2 + rr] = _swizzle(
                            16 * kk + 2 * qd + 8 * half + e, 16 * warp + g + 8 * rr)
        for k in range(16):
            flat = t + 128 * k
            want[2, t, k] = _swizzle(4 * flat // 128, 4 * flat % 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,n", SSD_PN)
def test_ssd_backward_bf16_at_every_head_and_state_width(cuda, p, n):
    """Every (P, N) with a template instance, bf16: the chunk kernel's and
    the pair kernels' reads of their swizzled tiles at every tile width,
    against the plain backward (chunk 32 over a ragged 100 positions, so a
    64-row tile also holds the next chunk's rows)."""
    _ssd_bwd_check(cuda, 2, 100, 3, p, n, 32, torch.bfloat16, True, seed=p * 100 + n)


@pytest.mark.parametrize("groups", [None, (8, 8)])
def test_ssd_backward_bf16_head_count_not_a_multiple_of_the_group(cuda, monkeypatch, groups):
    """12 heads at mamba2's widths over 300 positions (a ragged last
    chunk): with the heads per block the wrapper picks, and with 8 (groups
    of 8 and 4 heads, dB and dC summed over each in registers)."""
    from repro_torch.kernels import ssd_scan as ssd_module

    if groups is not None:
        monkeypatch.setattr(ssd_module, "backward_groups", lambda *shape: groups)
    _ssd_bwd_check(cuda, 2, 300, 12, 64, 128, 64, torch.bfloat16, True, seed=71)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BWD_MODEL_CASES)
def test_ssd_backward_bf16_is_bit_identical_at_the_model_shapes(cuda, b, s, h, p, n, chunk):
    """No atomics in the tensor-core backward: at mamba2-780m's and
    zamba2-2.7b's training shapes two calls, and the gradients through
    ``SSDScanFunction``, give the same bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    x, dt, a, bb, cc = _ssd_inputs(b, s, h, p, n, torch.bfloat16, cuda, seed=81)
    dy = _randn((b, s, h, p), torch.bfloat16, cuda, 82)
    first = ssd_scan_backward(x, dt, a, bb, cc, dy, None, chunk)
    second = ssd_scan_backward(x, dt, a, bb, cc, dy, None, chunk)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bb, cc)]
    y, _fin = ssd_scan(*leaves, chunk)
    auto = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(u, w) for u, w in zip(first, second))
    assert all(torch.equal(u, w) for u, w in zip(first, auto))


def test_ssd_function_under_autograd_on_the_card(cuda):
    """With grad on, the wrapper runs ``SSDScanFunction``: the forward's
    bits are those of the inference forward, one forward and one backward
    launch, and the gradients of every input are the backward kernels'."""
    from repro_torch.kernels.ssd_scan import ssd_scan_backward

    x, dt, a, bb, cc = _ssd_inputs(2, 300, 4, 64, 128, torch.bfloat16, cuda, seed=7)
    dy = _randn((2, 300, 4, 64), torch.bfloat16, cuda, 8)
    with torch.no_grad():
        y0, f0 = ops.ssd_scan(x, dt, a, bb, cc, chunk=64)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bb, cc)]
    fwd, bwd = ssd_scan.launches, ssd_scan.backward_launches
    y, fin = ops.ssd_scan(*leaves, chunk=64)
    assert y.requires_grad and torch.equal(y.detach(), y0) and torch.equal(fin.detach(), f0)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ssd_scan.launches - fwd, ssd_scan.backward_launches - bwd) == (1, 1)
    want = ssd_scan_backward(x, dt, a, bb, cc, dy, None, 64)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One batch of an fp32 smoke SSM or hybrid config on the card: every
    leaf gets a gradient (the SSD's through its backward kernels, one launch
    per Mamba2 layer; zamba2's shared attention through the flash backward)
    within 1e-4 of its largest |value| of the CPU's (autograd through the
    plain versions); then one AdamW step."""
    from repro_torch._device import tree_leaves
    from repro_torch.training import AdamWConfig, adamw_init, loss_and_grads, make_train_step

    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda p: p.to(cuda), params)
    tokens = np.random.default_rng(0).integers(0, cfg.raw_vocab_size, (2, 64))
    bwd = ssd_scan.backward_launches
    loss, _, grads = loss_and_grads(model, on_card, tokens)
    torch.cuda.synchronize()
    assert ssd_scan.backward_launches - bwd == cfg.num_layers
    loss_cpu, _, grads_cpu = loss_and_grads(model, params, tokens)
    torch.testing.assert_close(loss.cpu(), loss_cpu, rtol=2e-5, atol=0)
    for got, want in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        assert bool(torch.isfinite(want).all())
        assert _rel_err(got.cpu(), want) <= 1e-4
    new, opt, m = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))(
        on_card, adamw_init(on_card), tokens)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
    assert all(p.device.type == "cuda" for p in tree_leaves(new))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of a 2-layer fp32 smoke transformer on the card: every
    leaf gets a gradient (the attention weights through the flash backward,
    one backward launch per layer) within 1e-4 of its largest |value| of the
    CPU's (autograd through the plain version)."""
    from repro_torch._device import tree_leaves
    from repro_torch.training import AdamWConfig, adamw_init, loss_and_grads, make_train_step

    cfg = get_smoke_config("mistral-nemo-12b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = tree_map(lambda p: p.to(cuda), params)
    tokens = np.random.default_rng(0).integers(0, cfg.raw_vocab_size, (2, 64))
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    loss, _, grads = loss_and_grads(model, on_card, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches - fwd == cfg.num_layers
    assert flash_attention.backward_launches - bwd == cfg.num_layers
    loss_cpu, _, grads_cpu = loss_and_grads(model, params, tokens)
    torch.testing.assert_close(loss.cpu(), loss_cpu, rtol=2e-5, atol=0)
    for got, want in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        assert _rel_err(got.cpu(), want) <= 1e-4
    new, opt, m = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1))(
        on_card, adamw_init(on_card), tokens)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
    assert all(p.device.type == "cuda" for p in tree_leaves(new))


# --------------------------------------------------------------------------
# The kernels on a (1, 1) NCCL mesh: DTensor inputs through local_map
# --------------------------------------------------------------------------

@pytest.fixture
def mesh11(cuda):
    """A (1, 1) ("data", "model") mesh over a world of one NCCL rank, made
    and ended around the test."""
    from repro_torch.launch.mesh import launcher_world, make_host_mesh, set_mesh

    with launcher_world("cuda"):
        mesh = make_host_mesh(device="cuda")
        with set_mesh(mesh):
            yield mesh


def _on_mesh(t, mesh, grad=False):
    """``t`` as a batch-sharded ``DTensor`` (one rank: every axis replicated)."""
    from repro_torch.sharding.policy import P
    from repro_torch.sharding.utils import fit_spec, place

    d = place(t.detach(), fit_spec(tuple(t.shape), P("data"), mesh), mesh)
    return d.requires_grad_(grad)


def _ssd_case(cuda, dtype):
    b, s, h, p, n = 2, 256, 8, 64, 128
    g = torch.Generator(device="cpu").manual_seed(7)
    conv = torch.randn(b, s, h * p + 2 * n, generator=g).to(cuda, dtype)
    x = conv[..., :h * p].reshape(b, s, h, p)
    bc = conv[..., h * p:]
    dt = torch.rand(b, s, h, generator=g).to(cuda) * 0.1 + 0.01
    a = -torch.rand(h, generator=g).to(cuda) - 0.5
    return [x.contiguous(), dt, a, bc[..., :n].contiguous(), bc[..., n:].contiguous()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_on_a_mesh_gives_the_direct_calls_bits(mesh11, cuda, dtype):
    """``ops.ssd_scan`` of ``DTensor`` inputs (``local_map`` over the local
    rows and heads) launches the kernel once and returns the direct call's
    y and final state bit for bit; under autograd its backward kernel runs
    once and every gradient equals the direct call's."""
    args = _ssd_case(cuda, dtype)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, final = ops.ssd_scan(*leaves, 64)
    dy = torch.randn(y.shape, generator=torch.Generator(device="cpu").manual_seed(1)).to(
        cuda, y.dtype)
    grads = torch.autograd.grad(y, leaves, dy)
    fwd, bwd = ssd_scan.launches, ssd_scan.backward_launches
    on = [_on_mesh(t, mesh11, grad=True) for t in args]
    y_m, final_m = ops.ssd_scan(*on, 64)
    torch.cuda.synchronize()
    assert ssd_scan.launches == fwd + 1
    assert torch.equal(y_m.to_local(), y) and torch.equal(final_m.to_local(), final)
    grads_m = torch.autograd.grad(y_m, on, _on_mesh(dy, mesh11))
    torch.cuda.synchronize()
    assert ssd_scan.backward_launches == bwd + 1
    for got, want in zip(grads_m, grads):
        assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_on_a_mesh_gives_the_direct_calls_bits(mesh11, cuda, dtype):
    """``ops.flash_attention_bhsd`` of ``DTensor`` q, k, v under autograd:
    one forward and one backward launch, and the direct call's output and
    gradients bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(3)
    q, k, v, do = (torch.randn(2, 128, h, 128, generator=g).to(cuda, dtype)
                   for h in (8, 2, 2, 8))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_bhsd(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    fwd, bwd = flash_attention.launches, flash_attention.backward_launches
    on = [_on_mesh(t, mesh11, grad=True) for t in (q, k, v)]
    out_m = ops.flash_attention_bhsd(*on, causal=True)
    grads_m = torch.autograd.grad(out_m, on, _on_mesh(do, mesh11))
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention.backward_launches == bwd + 1
    assert torch.equal(out_m.to_local(), out)
    for got, want in zip(grads_m, grads):
        assert torch.equal(got.full_tensor(), want)


# --------------------------------------------------------------------------
# Head dim 192 (nemotron-4-340b) and the launch analysis's counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_head_dim_192(cuda, dtype, causal, window):
    """nemotron-4-340b's head_dim on the model layout, GQA 8/2: the forward
    in fp32 and bf16 to the reference sweep's tolerances, the bf16 backward
    against autograd of the plain version; the fp32 backward refuses it
    (its dK/dV kernel's staged tiles pass the shared memory a block may
    take)."""
    from repro_torch.kernels.flash_attention import FP32_BACKWARD_MAX_HEAD_DIM

    q = _randn((2, 150, 8, 192), dtype, cuda, 81)
    kv = _randn((2, 150, 2, 2, 192), dtype, cuda, 82)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), flash_attention_bhsd_ref(q, k, v, causal, window)
                               .float(), rtol=0, atol=tol)
    d_o = _randn((2, 150, 8, 192), dtype, cuda, 83)
    if dtype == torch.float32:
        assert FP32_BACKWARD_MAX_HEAD_DIM < 192
        with pytest.raises(ValueError, match="head_dim up to"):
            _flash_grads(q, k, v, d_o, causal, window)
        return
    _o, dq, dk, dv = _flash_grads(q, k, v, d_o, causal, window)
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), _plain_grads(q, k, v, d_o, causal, window)):
        assert _rel_err(got, want) <= FLASH_BWD_TOL[dtype]


def _kernel_calls(device, dtype):
    """Each kernel entry point under autograd where it has a backward, its
    inputs drawn on the CPU from one seed and moved to ``device``: (name,
    call) pairs, each call returning its outputs and gradients."""
    from repro_torch.kernels.pearson_affinity import pearson_dissimilarity as pearson

    g = torch.Generator().manual_seed(5)

    def leaf(*shape, dt=dtype):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dt).requires_grad_()

    q, k, v = leaf(2, 130, 8, 128), leaf(2, 130, 2, 128), leaf(2, 130, 2, 128)
    fq, fk, fv = (leaf(6, 70, 64).detach(), leaf(3, 90, 64).detach(), leaf(3, 90, 64).detach())
    x, dt_, a = leaf(2, 192, 4, 64), leaf(2, 192, 4, dt=torch.float32), leaf(4, dt=torch.float32)
    bb, cc = leaf(2, 192, 128), leaf(2, 192, 128)
    z = torch.randn(40, 300, generator=g).to(device)

    def flash():
        o = ops.flash_attention_bhsd(q, k, v, causal=True, window=100)
        return (o, *torch.autograd.grad(o.float().sum(), (q, k, v)))

    def flat():
        return (flash_attention(fq, fk, fv, causal=False, window=None),)

    def ssd():
        y, fin = ops.ssd_scan(x, dt_, a, bb, cc, 64)
        return (y, fin, *torch.autograd.grad(y.float().sum() + fin.sum(), (x, dt_, a, bb, cc)))

    def gram():
        return (pearson(z),)

    return (("flash", flash), ("flash_flat", flat), ("ssd", ssd), ("pearson", gram))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_kernel_counts_the_same_work_on_the_card_on_meta_and_on_the_cpu(cuda, dtype):
    """``analyze_step`` of each entry point: the same kernels, launches,
    FLOPs and bytes on a CUDA tensor, on meta and on the CPU, and on the
    card as many counted launches as the wrappers made."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_module_fn
    from repro_torch.launch.op_cost import analyze_step

    def launched():
        return {"pearson_gram": pearson_dissimilarity.launches,
                "flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention.backward_launches,
                "ssd_scan": ssd_module_fn.launches,
                "ssd_scan_bwd": ssd_module_fn.backward_launches}

    counts = {}
    for device in ("cuda", "meta", "cpu"):
        for name, call in _kernel_calls(device, dtype):
            before = launched()
            acc = analyze_step(call)
            torch.cuda.synchronize()
            counts[(device, name)] = acc["kernels"]
            assert acc["kernels"] and all(v["launches"] == 1 for v in acc["kernels"].values())
            if device == "cuda":
                after = launched()
                assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
                    {k: v["launches"] for k, v in acc["kernels"].items()}
    for name, _call in _kernel_calls("meta", dtype):
        assert counts[("cuda", name)] == counts[("meta", name)] == counts[("cpu", name)], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_paths_give_the_kernels_shapes_and_dtypes(cuda, dtype):
    """Each entry point on meta, forward and backward, gives the CUDA
    kernels' output and gradient shapes and dtypes, launching nothing."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_module_fn

    on_card = {name: call() for name, call in _kernel_calls("cuda", dtype)}
    torch.cuda.synchronize()
    before = (pearson_dissimilarity.launches, flash_attention.launches,
              flash_attention.backward_launches, ssd_module_fn.launches,
              ssd_module_fn.backward_launches)
    for name, call in _kernel_calls("meta", dtype):
        got = call()
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in on_card[name]]
        assert all(t.device.type == "meta" for t in got)
    assert before == (pearson_dissimilarity.launches, flash_attention.launches,
                      flash_attention.backward_launches, ssd_module_fn.launches,
                      ssd_module_fn.backward_launches)
