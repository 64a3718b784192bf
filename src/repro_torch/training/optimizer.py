"""Optimizers, the PyTorch port of ``repro.training.optimizer``.

Only :func:`sgd_update` is ported so far (the paper-scale CNN examples'
optimizer); AdamW, its schedule and clipping come with the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._device import tree_leaves, tree_map


@torch.no_grad()
def sgd_update(lr: float, grads: Any, params: Any) -> Any:
    """Plain SGD over a params tree: ``p - lr * g`` in fp32, cast back to
    each parameter's dtype.  ``grads`` has the layout of ``params``."""
    grad_leaves = iter(tree_leaves(grads))
    return tree_map(
        lambda p: (p.float() - lr * next(grad_leaves).float()).to(p.dtype),
        params,
    )
