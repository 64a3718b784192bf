"""Tests of the port that need an NVIDIA GPU (marked ``cuda``; each skips
where ``torch.cuda.is_available()`` is false).  This file imports no JAX,
so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import TaskGraph, TaskGraphExecutor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
from repro_torch.kernels.ref import (
    flash_attention_bhsd_ref, flash_attention_ref, pearson_dissimilarity_ref,
)
from repro_torch.models.multitask import build_cnn_program, build_transformer_program

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,f", [(16, 64), (37, 100), (64, 300), (512, 1568), (130, 7), (256, 655360)])
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
    with pytest.raises(ValueError):
        m = torch.empty(2, 8, 32, device="meta")
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
