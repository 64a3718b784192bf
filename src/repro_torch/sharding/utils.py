"""Spec utilities, the PyTorch port of ``repro.sharding.utils``: fit ideal
specs to a concrete mesh, and place tensors on it as ``DTensor``s.

:func:`fit_spec` drops any spec axis that (a) names a mesh axis absent from
the mesh, or (b) does not evenly divide the tensor dimension — with the
reference's fallback to the longest dividing prefix of a tuple entry.  Model
code declares the *ideal* layout once and tiny configs, odd widths and the
one-device mesh degrade to replication on that axis.

In place of the reference's ``to_named_shardings``:
:func:`placements` turns a spec into one ``Shard(dim)`` or ``Replicate()``
per mesh dimension, and :func:`place` builds a ``DTensor`` from this rank's
own slice of a tensor every rank holds in full (the program is built from
one seed on every rank), so placing costs no collective.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import tree_leaves
from repro_torch.sharding.policy import P, mesh_axes


def _axis_size(axes: dict, axis: Union[str, Tuple[str, ...]]) -> int:
    if isinstance(axis, tuple):
        return int(np.prod([axes[a] for a in axis]))
    return int(axes[axis])


def fit_spec(shape: Sequence[int], spec: Sequence[Any], mesh: Any) -> P:
    """Drop spec entries that don't exist in / divide over the mesh."""
    axes = mesh_axes(mesh)
    out: List[Any] = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        kept = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,)) if a in axes)
        if not kept:
            out.append(None)
            continue
        if dim % _axis_size(axes, kept) != 0:
            # Try progressively smaller prefixes of the axis tuple.
            while kept and dim % _axis_size(axes, kept) != 0:
                kept = kept[:-1]
            out.append(kept if kept else None)
            continue
        out.append(kept if len(kept) > 1 else kept[0])
    return P(*out)


def fit_specs(shapes: Any, specs: Any, mesh: Any) -> Any:
    """:func:`fit_spec` over matching nested dicts / lists of shapes (a
    tensor or a shape tuple at each leaf) and specs."""
    if isinstance(specs, P):
        shape = shapes.shape if hasattr(shapes, "shape") else tuple(shapes)
        return fit_spec(shape, specs, mesh)
    if isinstance(specs, dict):
        return {k: fit_specs(shapes[k], v, mesh) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(fit_specs(s, v, mesh) for s, v in zip(shapes, specs))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def tree_bytes(tree: Any) -> int:
    """Total bytes of a tree of tensors (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def placements(spec: Sequence[Any], mesh: Any) -> Tuple[Any, ...]:
    """One ``Shard(dim)`` or ``Replicate()`` per mesh dimension, in mesh order.

    A tuple entry shards its tensor dimension over each of its mesh axes;
    the split then follows mesh order, which is the reference's device order
    only when the tuple lists its axes in mesh order — any other order is
    refused.  A mesh axis of size 1 splits nothing, so it is ``Replicate()``
    whatever the spec says: DTensor refuses to view or squeeze a dimension
    that carries a ``Shard``, even a one-way one.
    """
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_axes(mesh)
    names = list(sizes)
    where = {}
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {ax!r} is not in the mesh's axis order {tuple(names)}"
            )
        for a in group:
            if a in where:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec!r}")
            where[a] = dim
    return tuple(Shard(where[a]) if a in where and sizes[a] > 1 else Replicate()
                 for a in names)


def _local_slice(tensor: torch.Tensor, spec: Sequence[Any], mesh: Any) -> torch.Tensor:
    """This rank's slice of ``tensor`` under ``spec`` (which must divide
    evenly: pass it through :func:`fit_spec` first)."""
    coord = mesh.get_coordinate()
    out = tensor
    for mdim, pl in enumerate(placements(spec, mesh)):
        if pl.is_replicate():
            continue
        n = mesh.size(mdim)
        size = out.shape[pl.dim]
        if size % n:
            raise ValueError(
                f"dim {pl.dim} of size {size} does not split {n} ways; fit the spec"
            )
        step = size // n
        out = out.narrow(pl.dim, coord[mdim] * step, step)
    return out


def place(tensor: torch.Tensor, spec: Sequence[Any], mesh: Any) -> Any:
    """``tensor`` (held in full by every rank) as a ``DTensor`` laid out by
    ``spec``: ``DTensor.from_local`` of this rank's own slice, unchecked, so
    no collective runs."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        _local_slice(tensor, spec, mesh).contiguous(), mesh,
        placements(spec, mesh), run_check=False,
        shape=tensor.shape, stride=_contiguous_strides(tensor.shape),
    )


def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, step = [], 1
    for size in reversed(tuple(shape)):
        strides.append(step)
        step *= max(int(size), 1)
    return tuple(reversed(strides))
