"""Tests of the port that need an NVIDIA GPU (marked ``cuda``; each skips
where ``torch.cuda.is_available()`` is false).  This file imports no JAX,
so it runs on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import TaskGraph, TaskGraphExecutor
from repro_torch.kernels import ops
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
from repro_torch.kernels.ref import pearson_dissimilarity_ref
from repro_torch.models.multitask import build_cnn_program

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,f", [(16, 64), (37, 100), (64, 300), (512, 1568), (130, 7)])
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
