"""Public wrappers around the port's kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.pearson_affinity import pearson_dissimilarity


def standardize_rows(feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """fp32 rows centred and scaled to unit L2 norm (Pearson normalisation),
    as ``repro/kernels/ops.py`` does before its kernel."""
    z = feats.float()
    z = z - z.mean(dim=-1, keepdim=True)
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=eps)


def pairwise_pearson_dissimilarity(feats: torch.Tensor) -> torch.Tensor:
    """Standardise the rows of ``feats`` (K, F) in fp32, then ``1 - Gram``.

    Any input dtype (bf16 included) is cast to fp32 first; the result is
    (K, K) fp32.  A CUDA input launches the Pearson kernel.
    """
    return pearson_dissimilarity(standardize_rows(feats).contiguous())
