"""Checkpointing: params trees <-> .npz with path-string keys, the PyTorch
port of ``repro.training.checkpoint``.

Every leaf is saved under its joined tree path, as the reference names it
(dict keys, sequence indices, ``NamedTuple`` field names such as
``AdamWState``'s ``step``, ``mu`` and ``nu``, joined by ``/``), with the step
under ``__step__``; restore rebuilds into a reference tree of the same
structure.  So a checkpoint written by either package restores in the
other.  A bf16 leaf is written as the reference's numpy writes it without
knowing the type: its raw 2-byte values (numpy's ``V2``), which this module
reads back bit-exactly without ``ml_dtypes``.  Writes are atomic: a
temporary file in the same directory, then ``os.replace``.

A tree on a mesh saves each ``DTensor`` leaf whole (``full_tensor``, a
collective every rank joins), so one checkpoint restores off the mesh, in
the reference and on any mesh; restoring into a reference tree of
``DTensor``s lays each leaf out in its reference leaf's placements.
Every rank then writes the same bytes, and the atomic write leaves one
whole file where ranks share a path.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.utils import is_dtensor, place_like


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs of ``tree``: dicts by key, ``NamedTuple``s by
    field name, lists and tuples by index; anything else is a leaf."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in _flatten(getattr(tree, f), prefix + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree: Any, leaf: Callable[[str, Any], Any], prefix: Tuple[str, ...] = ()) -> Any:
    """``tree`` with each leaf replaced by ``leaf(path key, old leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf, prefix + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf, prefix + (str(i),)) for i, v in enumerate(tree))
    return leaf("/".join(prefix), tree)


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the array the reference would save: bf16 as raw ``V2``."""
    if isinstance(leaf, torch.Tensor):
        t = (leaf.full_tensor() if is_dtensor(leaf) else leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``ref``'s dtype and device; raw 2-byte values
    (``V2``) or a bf16 array read as bf16 bits."""
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read {arr.dtype} as bf16")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return place_like(t.to(device=ref.device, dtype=ref.dtype), ref)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Atomically write ``tree`` to ``path`` (.npz)."""
    flat = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    flat["__step__"] = np.asarray(step)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_checkpoint(path: str, reference: Any) -> Tuple[Any, int]:
    """Load into the structure of ``reference``, each leaf on the device and
    in the dtype (on a mesh, in the placements) of ``reference``'s.
    Returns (tree, step)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    step = int(arrays.pop("__step__", np.asarray(0)))

    def leaf(key: str, ref: Any) -> Any:
        if key not in arrays:
            raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs ref {tuple(ref.shape)}"
            )
        if isinstance(ref, torch.Tensor):
            return _to_tensor(arr, ref)
        return np.asarray(arr, dtype=np.asarray(ref).dtype)

    return _rebuild(reference, leaf), step


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = re.match(rf"{re.escape(prefix)}(\d+)\.npz$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best
