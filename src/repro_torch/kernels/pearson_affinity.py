"""The pairwise inverse-Pearson Gram ``1 - Z Z^T`` (paper §3.1 Step 1).

The compute hot spot of Antler's affinity analysis: one call per task and
branch point, O(K^2 F).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/pearson_gram.cu``, which replaces the Pallas TPU kernel
``repro/kernels/pearson_affinity.py::pearson_dissimilarity``.  On a CPU
tensor it runs the plain version, :func:`~repro_torch.kernels.ref.\
pearson_dissimilarity_ref`; there is no other fallback.

Bound on an H100: 2*K*K*F fp32 FLOPs on the CUDA cores (no TF32: the
reference holds this function to 1e-5) against K*F*4 + K*K*4 bytes — at the
main path's K = 512, F = 1568, 0.82 GFLOP over 4.3 MB, so it is bound by
operations.  The kernel computes each 64x64 tile once with a 4x4 register
micro-tile per thread, and only the upper tiles, mirroring them, which also
makes the output exactly symmetric.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pearson_dissimilarity_ref

SOURCE = "pearson_gram.cu"


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.pearson_gram
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def pearson_dissimilarity(z: torch.Tensor) -> torch.Tensor:
    """``1 - Z Z^T`` for row-standardised ``z`` (K, F).  Returns (K, K) fp32.

    A CUDA ``z`` must be fp32, 2-D and contiguous; the kernel launches on
    the current stream and :attr:`pearson_dissimilarity.launches` counts it.
    """
    if z.device.type == "cpu":
        return pearson_dissimilarity_ref(z)
    if z.dtype != torch.float32:
        raise TypeError(f"pearson_dissimilarity takes fp32, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"pearson_dissimilarity takes a 2-D (K, F) tensor, got {tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError("pearson_dissimilarity takes a contiguous tensor")
    if z.device.type != "cuda":
        raise ValueError(f"pearson_dissimilarity runs on cuda or cpu, not {z.device}")
    k, f = z.shape
    out = torch.empty((k, k), dtype=torch.float32, device=z.device)
    if k == 0:
        return out
    lib = _library()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.pearson_gram(z.data_ptr(), out.data_ptr(), k, f, stream)
    if err != 0:
        raise RuntimeError(f"pearson_gram launch failed: CUDA error {err}")
    pearson_dissimilarity.launches += 1
    return out


pearson_dissimilarity.launches = 0
