"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no GPU and no explicit device it raises rather than
    carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a params tree (dicts, lists,
    tuples and NamedTuples of tensors — the layout of the reference's
    pytrees)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a params tree, in :func:`tree_map`'s order."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor leaf of a params tree, or ``None``."""
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ()
    )
    for v in values:
        t = first_tensor(v)
        if t is not None:
            return t
    return None
