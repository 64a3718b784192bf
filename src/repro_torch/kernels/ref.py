"""Plain PyTorch versions of the port's kernels.

The CPU path of each kernel wrapper, and what the kernels are held against
on the card.
"""
from __future__ import annotations

import torch


def pearson_dissimilarity_ref(z: torch.Tensor) -> torch.Tensor:
    """``1 - Z Z^T`` in fp32 for row-standardised ``z`` (K, F)."""
    z = z.float()
    return 1.0 - z @ z.T
