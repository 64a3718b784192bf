"""Logical-axis sharding policy, the PyTorch port of
``repro.sharding.policy``.

Model code annotates tensors with *logical* axes (``batch``, ``model``,
``fsdp``, ``expert``, ``seq``); the policy maps those to physical mesh axes,
so the same code runs on the single-pod ``(data, model)`` mesh, the
multi-pod ``(pod, data, model)`` mesh, and on one device (where constraints
are no-ops).

A spec is the port's own :class:`P`: a tuple with one entry per tensor
dimension, each ``None`` (replicated), a mesh axis name, or a tuple of mesh
axis names (the dimension split over all of them, in mesh order).  The
ambient mesh is a ``contextvars`` variable that
:func:`repro_torch.launch.mesh.set_mesh` sets; :func:`shard_act` is
``DTensor.redistribute`` to a spec's placements.

Two built-in policies, as in the reference:

* ``TP_POLICY`` — tensor parallelism over ``model``, batch over ``data``
  (+ ``pod``), parameters replicated across data;
* ``FSDP_TP_POLICY`` — parameters additionally sharded over the data axis
  (ZeRO-3 style).
"""
from __future__ import annotations

import contextvars
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Logical = Union[None, str, Tuple[str, ...]]

#: The mesh installed by :func:`repro_torch.launch.mesh.set_mesh`.
CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None
)


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``, a
    mesh axis name, or a tuple of mesh axis names.  A one-name tuple is that
    name, as JAX's ``PartitionSpec`` normalises it."""

    def __new__(cls, *entries: Logical) -> "P":
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh: a ``DeviceMesh`` (``mesh_dim_names``
    and a shape tuple), or any object with ``axis_names`` and a ``shape``
    mapping (the reference's ``Mesh`` interface)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _ambient_mesh() -> Any:
    """The mesh installed by ``set_mesh``, or ``None``.  A failure to read it
    surfaces: it never degrades every spec to replicated."""
    return CURRENT_MESH.get()


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Maps logical tensor axes to physical mesh axes.

    Attributes:
      batch: mesh axes carrying the batch (``("data",)`` or
        ``("pod", "data")``).
      model: mesh axis for tensor parallelism (heads / d_ff / vocab).
      fsdp: mesh axis over which parameters are additionally sharded
        (None = replicated across data — the baseline).
      expert: mesh axis for expert parallelism of MoE stacks (None = experts
        co-located, TP inside each expert — the baseline).
    """

    name: str
    batch: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"
    fsdp: Optional[str] = None
    expert: Optional[str] = None

    def physical(self, logical: Logical):
        """Resolve one logical axis to mesh axes (or None)."""
        if logical is None:
            return None
        if logical == "batch":
            return self.batch if len(self.batch) > 1 else self.batch[0]
        if logical == "model":
            return self.model
        if logical == "fsdp":
            return self.fsdp
        if logical == "expert":
            return self.expert
        if logical == "seq":
            return None  # sequence never sharded in this framework
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical_axes: Logical) -> P:
        """Spec from logical axes, dropping axes absent from the ambient mesh
        (lets the same model run on one device)."""
        mesh = _ambient_mesh()
        names = set(mesh_axes(mesh)) if mesh is not None else set()

        def keep(ax):
            if ax is None:
                return None
            if isinstance(ax, tuple):
                kept = tuple(a for a in ax if a in names)
                return kept if kept else None
            return ax if ax in names else None

        return P(*[keep(self.physical(a)) for a in logical_axes])

    def param_spec(self, shape: Sequence[int]) -> P:
        """Ideal weight layout for one parameter leaf of ``shape``.

        Matrices (and higher) shard their first axis over ``fsdp`` (None
        under TP) and their last axis over ``model``; vectors and scalars
        replicate.  Callers pass the result through
        :func:`repro_torch.sharding.utils.fit_spec` so axes absent from the
        mesh — or not dividing the dimension — degrade to replication.
        """
        nd = len(shape)
        if nd < 2:
            return P(*([None] * nd))
        return P(self.fsdp, *([None] * (nd - 2)), self.model)

    def data_shards(self, mesh: Any) -> int:
        """How many ways the batch dimension splits on ``mesh`` (the
        per-shard multiple the request-group scheduler must pad to)."""
        if mesh is None:
            return 1
        axes = mesh_axes(mesh)
        n = 1
        for a in self.batch:
            if a in axes:
                n *= axes[a]
        return n

    def weight_shards(self, mesh: Any) -> int:
        """How many ways parameters split on ``mesh`` (the divisor on the
        cost model's weight-load term: each chip streams only its slice)."""
        if mesh is None:
            return 1
        axes = mesh_axes(mesh)
        n = 1
        for a in sorted({a for a in (self.model, self.fsdp) if a is not None}):
            if a in axes:
                n *= axes[a]
        return n


TP_POLICY = ShardingPolicy(name="tp", batch=("pod", "data"))
FSDP_TP_POLICY = ShardingPolicy(
    name="fsdp_tp", batch=("pod", "data"), fsdp="data"
)
EXPERT_TP_POLICY = ShardingPolicy(
    name="expert_tp", batch=("pod", "data"), expert="model"
)
FSDP_EXPERT_POLICY = ShardingPolicy(
    name="fsdp_expert", batch=("pod", "data"), fsdp="data", expert="model"
)

POLICIES = {
    p.name: p
    for p in (TP_POLICY, FSDP_TP_POLICY, EXPERT_TP_POLICY, FSDP_EXPERT_POLICY)
}


def shard_act(x: Any, policy: ShardingPolicy, *logical_axes: Logical) -> Any:
    """Redistribute an activation ``DTensor`` to the policy's layout for
    ``logical_axes``; without a mesh, or for a plain tensor, ``x`` itself.

    The spec is fitted to ``x``'s shape first (``fit_spec``): an axis that
    does not divide its dimension (a decode step's one routing group over
    four data ranks) leaves that dimension replicated where XLA would pad
    it; the values are the same.  The local shards come back contiguous:
    a split along a minor dimension is a strided view, which DTensor's
    matmul and einsum rules then fail to view."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.utils import fit_spec, placements

    mesh = _ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = policy.spec(*logical_axes)
    if all(s is None for s in spec):
        return x
    spec = fit_spec(tuple(x.shape), spec, mesh)
    y = x.redistribute(mesh, placements(spec, mesh))
    local = y.to_local()
    if local.is_contiguous():
        return y
    # ``DTensor.contiguous`` reads the global strides and keeps the view.
    return DTensor.from_local(local.contiguous(), mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())
