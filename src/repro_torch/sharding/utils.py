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


def _from_full(tensor: torch.Tensor, pls: Sequence[Any], mesh: Any) -> Any:
    """``DTensor.from_local`` of this rank's slice of ``tensor`` under
    placements ``pls`` (which must split evenly: fit the spec first),
    unchecked, so no collective runs."""
    from torch.distributed.tensor import DTensor

    local = tensor
    for dim, (off, n) in enumerate(local_extent(tensor.shape, pls, mesh)):
        local = local.narrow(dim, off, n)
    return DTensor.from_local(local.contiguous(), mesh, pls, run_check=False,
                              shape=tensor.shape, stride=_contiguous_strides(tensor.shape))


def place(tensor: torch.Tensor, spec: Sequence[Any], mesh: Any) -> Any:
    """``tensor`` (held in full by every rank) as a ``DTensor`` laid out by
    ``spec``, built from this rank's own slice: no collective runs."""
    return _from_full(tensor, placements(spec, mesh), mesh)


def _contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides, step = [], 1
    for size in reversed(tuple(shape)):
        strides.append(step)
        step *= max(int(size), 1)
    return tuple(reversed(strides))


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_of(tree: Any) -> Any:
    """The ``DeviceMesh`` of the first ``DTensor`` leaf of ``tree`` (a params
    tree placed on a mesh), or ``None`` off a mesh."""
    for leaf in tree_leaves(tree):
        if is_dtensor(leaf):
            return leaf.device_mesh
    return None


def on_mesh(tree: Any):
    """The context a computation over ``tree`` runs in: on a mesh, DTensor's
    ``implicit_replication``, so plain tensors that every rank makes alike
    (positions, masks, a clip scale) count as replicated; off a mesh, or
    inside an enclosing one, a no-op (``implicit_replication`` clears its
    flag on exit, so it must not nest)."""
    import contextlib

    from torch.distributed.tensor import DTensor

    if mesh_of(tree) is None or DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def place_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """Every leaf of ``tree`` placed on ``mesh`` by its spec in ``specs`` (a
    matching tree of :class:`P`), fitted first (:func:`fit_spec`); the
    result keeps ``tree``'s key order."""
    if isinstance(specs, P):
        return place(tree, fit_spec(tuple(tree.shape), specs, mesh), mesh)
    if isinstance(specs, dict):
        if set(tree) != set(specs):
            raise ValueError(f"tree keys {sorted(tree)} differ from spec keys {sorted(specs)}")
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(place_tree(t, v, mesh) for t, v in zip(tree, specs))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def local_extent(shape: Sequence[int], pls: Sequence[Any], mesh: Any) -> List[Tuple[int, int]]:
    """(offset, length) per tensor dimension of this rank's shard of a
    tensor of ``shape`` with placements ``pls`` on ``mesh``: each
    ``Shard(d)`` splits the current extent of dimension d evenly, in mesh
    order (the layout :func:`place` builds)."""
    coord = mesh.get_coordinate()
    ext = [(0, int(s)) for s in shape]
    for mdim, pl in enumerate(pls):
        if not pl.is_shard():
            continue
        off, size = ext[pl.dim]
        n = mesh.size(mdim)
        if size % n:
            raise ValueError(
                f"dim {pl.dim} of size {size} does not split {n} ways; fit the spec")
        step = size // n
        ext[pl.dim] = (off + coord[mdim] * step, step)
    return ext


def write_rows(buf: Any, dim: int, start: int, values: Any) -> None:
    """``buf.narrow(dim, start, n).copy_(values)``, in place, for a plain
    tensor or a ``DTensor`` ``buf``; rows past the end of ``dim`` wrap to
    its start, as slots of a ring buffer do (``n`` at most ``dim``'s size).

    On a mesh the write is made on the local shards and ``buf`` keeps its
    layout: ``values`` is first brought to ``buf``'s placements with
    dimension ``dim`` whole (already so, nothing moves), then each rank
    writes the rows of ``[start, start + n)`` that fall in its own slice of
    ``dim`` — where ``dim`` is sharded (a sequence-sharded cache) only the
    rank holding a slot writes it.
    """
    from torch.distributed.tensor import DTensor, Replicate

    n, size = values.shape[dim], buf.shape[dim]
    # (first row of buf, first row of values, rows): the part before the
    # end of dim, then the part that wraps.
    pieces = [(start, 0, min(n, size - start))]
    if start + n > size:
        pieces.append((0, size - start, start + n - size))
    if not isinstance(buf, DTensor):
        for at, src, rows in pieces:
            buf.narrow(dim, at, rows).copy_(values.narrow(dim, src, rows))
        return
    mesh, pls = buf.device_mesh, buf.placements
    whole = [Replicate() if pl.is_shard(dim) else pl for pl in pls]
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vals = values.redistribute(mesh, whole).to_local()
    off, local = local_extent(buf.shape, pls, mesh)[dim]
    for at, src, rows in pieces:
        lo, hi = max(at, off), min(at + rows, off + local)
        if lo < hi:
            buf.to_local().narrow(dim, lo - off, hi - lo).copy_(
                vals.narrow(dim, src + lo - at, hi - lo))


def place_batch(x: Any, policy: Any, mesh: Any) -> Any:
    """A batch-leading input (token ids, features) on ``mesh``: its leading
    axis over the policy's batch axes where they divide it, the rest
    replicated; a ``DTensor`` passes through."""
    if is_dtensor(x):
        return x
    spec = fit_spec(tuple(x.shape), P(policy.physical("batch")), mesh)
    return place(x, spec, mesh)


def place_like(tensor: torch.Tensor, ref: Any) -> Any:
    """``tensor`` (held in full by every rank) in ``ref``'s layout: a
    ``DTensor`` of ``ref``'s mesh and placements built from this rank's own
    slice (no collective); ``tensor`` itself where ``ref`` is a plain
    tensor."""
    if not is_dtensor(ref):
        return tensor
    return _from_full(tensor, ref.placements, ref.device_mesh)


def gather_fsdp(tree: Any, policy: Any) -> Any:
    """``tree``'s ``DTensor`` leaves with their ``policy.fsdp`` shards
    gathered (ZeRO-3's all-gather before a layer computes; its backward is
    the gradient's reduce-scatter); every other leaf, and every leaf off a
    mesh or under a policy without ``fsdp``, as it is."""
    from repro_torch._device import tree_map

    if policy.fsdp is None or mesh_of(tree) is None:
        return tree
    from torch.distributed.tensor import Replicate

    def one(t: Any) -> Any:
        if not is_dtensor(t):
            return t
        names = t.device_mesh.mesh_dim_names
        pls = [Replicate() if names[i] == policy.fsdp else pl for i, pl in enumerate(t.placements)]
        return t if tuple(pls) == tuple(t.placements) else t.redistribute(t.device_mesh, pls)

    return tree_map(one, tree)


def mesh_pad(x: Any, widths: Sequence[int], value: float = 0.0) -> Any:
    """``F.pad(x, widths, value=value)``; a ``DTensor`` is padded per rank
    through ``local_map``, each padded dimension whole on every rank and the
    rest as laid out.  (DTensor's own rule for the pad's backward yields a
    malformed gradient layout on torch 2.11.)"""
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    padded = {x.ndim - 1 - i for i in range(len(widths) // 2)
              if widths[2 * i] or widths[2 * i + 1]}
    pls = [Replicate() if pl.is_shard() and pl.dim in padded else pl for pl in x.placements]
    return local_map(lambda t: F.pad(t, widths, value=value), out_placements=pls,
                     in_placements=(pls,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def column_einsum(eq: str, x: Any, w: Any, w_dim: int, out_dim: int) -> Any:
    """``torch.einsum(eq, x, w)`` of a batch-leading activation ``x`` and a
    weight ``w`` whose dimension ``w_dim`` — a column the output keeps, at
    ``out_dim`` — may be split over the mesh: a fused projection such as
    ``bsd,dkf->bskf`` with the stacked gate and up columns split.

    Off a mesh the plain einsum.  On a mesh each rank multiplies its own
    batch rows by its own weight columns through ``local_map`` (every other
    weight dimension gathered whole, as FSDP does): the reference's
    column-parallel product.  DTensor's own einsum views a fused weight as
    one flat column dimension, which torch 2.11 refuses when the split
    dimension is not the first of the flattened ones.  Gradients come back
    as partial sums where a rank read only part of the other operand: the
    weight's over the batch shards, ``x``'s over the column shards.
    """
    if not is_dtensor(w):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    # Per mesh dim, the placements of (x, w, the output, x's grad, w's grad):
    # column-split, batch-split or replicated.
    rows = []
    for wp, xp in zip(w.placements, x.placements):
        if wp == Shard(w_dim):
            rows.append((Replicate(), wp, Shard(out_dim), Partial(), wp))
        elif xp == Shard(0):
            rows.append((xp, Replicate(), xp, xp, Partial()))
        else:
            rows.append((Replicate(),) * 5)
    xs, ws, out, xg, wg = (list(c) for c in zip(*rows))
    return local_map(
        lambda a, b: torch.einsum(eq, a, b), out_placements=out, in_placements=(xs, ws),
        in_grad_placements=(xg, wg), device_mesh=mesh, redistribute_inputs=True,
    )(x, w)



def row_einsum(eq: str, x: Any, w: Any, x_dim: int, w_dim: int) -> Any:
    """``torch.einsum(eq, x, w)`` of a batch-leading activation ``x`` and a
    weight ``w`` that contract ``x``'s dimension ``x_dim`` with ``w``'s
    ``w_dim``, which may be split over the mesh: an output projection such
    as ``bshk,hkd->bsd`` with the heads split, the counterpart of
    :func:`column_einsum`.

    Off a mesh the plain einsum.  On a mesh each rank multiplies its own
    batch rows of its own contraction shard by its own weight rows through
    ``local_map`` (every other weight dimension gathered whole): the
    reference's row-parallel product.  The output is a partial sum over the
    mesh dimensions that split the contraction, which the caller's
    ``shard_act`` reduces.  ``x``'s gradient is ``dout @ w_localᵀ`` on its
    own shard and the weight's gradient lands in its own rows, a partial
    sum over the batch shards.  (DTensor's own einsum multiplies one of the
    two gradients at full width.)
    """
    if not is_dtensor(w):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    # Per mesh dim, the placements of (x, w, the output, x's grad, w's grad):
    # contraction-split, batch-split or replicated.
    rows = []
    for wp, xp in zip(w.placements, x.placements):
        if wp == Shard(w_dim):
            rows.append((Shard(x_dim), wp, Partial(), Shard(x_dim), wp))
        elif xp == Shard(0):
            rows.append((xp, Replicate(), xp, xp, Partial()))
        else:
            rows.append((Replicate(),) * 5)
    xs, ws, out, xg, wg = (list(c) for c in zip(*rows))
    return local_map(
        lambda a, b: torch.einsum(eq, a, b), out_placements=out, in_placements=(xs, ws),
        in_grad_placements=(xg, wg), device_mesh=mesh, redistribute_inputs=True,
    )(x, w)


def gathered_einsum(eq: str, x: Any, w: Any, w_dim: int, out_dim: int) -> Any:
    """``torch.einsum(eq, x, w)`` of a batch-leading activation ``x`` and a
    weight ``w`` held whole over the mesh dimensions that do not split the
    batch, where every rank needs the whole output: Mamba2's B and C
    projections, shared by the heads that each ``model`` rank holds.

    Off a mesh the plain einsum.  On a mesh each rank multiplies its own
    batch rows by its own slice of the weight's columns (``w_dim``, which
    the output keeps at ``out_dim``) over every such dimension that the
    columns divide, through :func:`column_einsum`, and the output's slices
    are gathered: the product costs each rank its share, not the whole.
    The weight's gradient lands in its own columns, a partial sum over the
    ranks; ``x``'s is reduced over the column slices.
    """
    if not (is_dtensor(w) and is_dtensor(x)):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    split, n = [], 1
    for mdim, (wp, xp) in enumerate(zip(w.placements, x.placements)):
        size = mesh.size(mdim)
        ok = xp != Shard(0) and wp == Replicate() and size > 1
        if ok and w.shape[w_dim] % (n * size) == 0:
            n *= size
            split.append(True)
        else:
            split.append(False)
    if n == 1:
        return column_einsum(eq, x, w, w_dim, out_dim)
    off, cols = local_extent(w.shape, [Shard(w_dim) if sp else Replicate() for sp in split],
                             mesh)[w_dim]
    cut = local_map(
        lambda a: a.narrow(w_dim, off, cols).contiguous(),
        out_placements=[Shard(w_dim) if sp else pl for sp, pl in zip(split, w.placements)],
        in_placements=(list(w.placements),),
        in_grad_placements=([Partial() if sp else pl for sp, pl in zip(split, w.placements)],),
        device_mesh=mesh, redistribute_inputs=True,
    )(w)
    y = column_einsum(eq, x, cut, w_dim, out_dim)
    return y.redistribute(mesh, [Replicate() if sp else pl for sp, pl in zip(split, y.placements)])


def mesh_reduce(t: torch.Tensor, op: str, mesh: Any, dims: Sequence[int]) -> torch.Tensor:
    """``t`` (a rank's local tensor, inside ``local_map``) all-reduced with
    ``op`` (``"sum"``, ``"max"``) over each mesh dimension of ``dims`` in
    turn, through functional collectives (so the collective recorder counts
    them)."""
    from torch.distributed import _functional_collectives as funcol

    for mdim in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, mdim)))
    return t


class _MeshSum(torch.autograd.Function):
    """The all-reduce sum of :func:`mesh_sum`; its gradient is the
    all-reduce sum of the gradients, since every rank reads the sum."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return mesh_reduce(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return mesh_reduce(grad.contiguous(), "sum", ctx.mesh, ctx.dims), None, None


def mesh_sum(t: torch.Tensor, mesh: Any, dims: Sequence[int]) -> torch.Tensor:
    """:func:`mesh_reduce` with ``"sum"``, differentiable: a statistic that
    each rank sums over its own slice of a split dimension (a norm's sum of
    squares), made whole on every rank."""
    return _MeshSum.apply(t, mesh, list(dims))
