"""Per-rank FLOPs, bytes and collective bytes of one step, the port's
counterpart of ``repro.launch.hlo_cost``.

The reference walks a compiled HLO module.  Eager PyTorch has no HLO, so
:func:`analyze_step` runs the step once under an :class:`OpCounter` and a
:class:`~repro_torch.sharding.collectives.CollectiveRecorder` and returns
``analyze_hlo``'s keys (``flops``, ``bytes``, ``collective_bytes`` and one
``coll_<kind>`` per kind), all counted **on this rank**, over its local
shards:

* FLOPs from ``torch.utils.flop_counter``'s formulas (``flop_registry``)
  over the aten ops left after ``DTensor`` desugars into local ops.  The
  counter returns ``NotImplemented`` for ``DTensor`` (as the recorder
  does) and skips every op on ``FakeTensor``s: DTensor's sharding
  propagation runs an op on global-shape fake tensors the first time it
  sees a layout, which would add the global product once.  It is not
  ``FlopCounterMode``, which over DTensors counts the global product.
* Bytes: each aten op's tensor operands plus its results (a broadcast
  dimension once; the old value of a tensor that ``copy_``, ``zero_`` or
  ``fill_`` overwrites not read).  Views,
  allocations, ``detach``, copies to ``meta`` and the like are free, as the
  reference's ``_FREE_OPS`` are; collectives are counted in the collective
  bytes only.  Eager mode fuses nothing, so there is nothing to subtract.
* The hand kernels launch through ``ctypes``, beneath the dispatcher: each
  kernel wrapper reports its formula from :mod:`repro_torch.launch.roofline`
  once per launch through :func:`kernel` (an explicit hook rather than a
  ``torch.library`` custom op: the wrappers already route by device, and a
  hook adds no op schema to the CUDA path).  The count is the same whichever
  route runs the call: the CUDA kernel, the plain version on a CPU tensor
  (whose own aten ops are not counted on top), or a meta shape run.
* Peak live bytes: every tensor an op allocates on this rank (a result
  whose storage no operand shares) adds its storage's bytes until a
  ``weakref`` finalizer sees it freed.

Importing this module makes no process group and touches no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch._device import tree_leaves
from repro_torch.launch.roofline import COLLECTIVE_KINDS, Work
from repro_torch.sharding.collectives import CollectiveRecorder

_aten = torch.ops.aten
# Ops that move no data: allocations, and ops returning a tensor that
# shares its operand's storage without a view schema.
_FREE_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default, _aten.set_.source_Storage,
    _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
}


def _is_free(func, ins: list, out: Any) -> bool:
    if func in _FREE_OPS or func.is_view:
        return True
    if func.namespace == "_c10d_functional":
        return True  # the collective bytes count these
    if func is _aten._to_copy.default:  # free only as a move onto meta
        return (all(t.device.type == "meta" for t in tree_leaves(out))
                and all(t.device.type != "meta" for t in ins))
    return False


# Ops that only write their first operand: its old value is not read.
_WRITE_ONLY_SELF = {_aten.copy_.default, _aten.zero_.default, _aten.fill_.Scalar,
                    _aten.fill_.Tensor}


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _traffic(t: torch.Tensor) -> int:
    """Bytes an op moves reading or writing ``t``: its elements, a
    broadcast (stride-0) dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _leaves(args: Any, kwargs: Any) -> list:
    return tree_leaves([list(args), dict(kwargs or {})])


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of the aten ops and hand kernels run inside
    it on this rank (``with OpCounter() as c: ...``).

    ``flops`` and ``bytes`` are the totals; ``kernels`` holds, per hand
    kernel, its ``launches`` and their ``flops`` and ``bytes``; ``ops`` the
    count, FLOPs and bytes of every aten op by name; ``peak_bytes`` the
    most bytes that ops inside allocated and held at once.
    """

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._quiet = 0
        self._live: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # desugar into local ops first
        out = func(*args, **(kwargs or {}))
        ins = [t for t in _leaves(args, kwargs) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + tree_leaves(out)):
            return out  # DTensor's sharding propagation, on global shapes
        self._track(ins, out)
        if self._quiet:
            return out
        flops = 0.0
        if not _is_free(func, ins, out):
            from torch.utils.flop_counter import flop_registry

            formula = flop_registry.get(func.overloadpacket)
            if formula is not None:
                flops = float(formula(*args, **(kwargs or {}), out_val=out))
            read = ins[1:] if func in _WRITE_ONLY_SELF else ins
            nbytes = float(sum(_traffic(t) for t in read + tree_leaves(out)))
            row = self.ops.setdefault(str(func.overloadpacket), {"count": 0, "flops": 0.0,
                                                                 "bytes": 0.0})
            row["count"] += 1
            row["flops"] += flops
            row["bytes"] += nbytes
            self.flops += flops
            self.bytes += nbytes
        return out

    def _track(self, ins: list, out: Any) -> None:
        """Add each result's storage that no operand shares to the live
        bytes, until the result is freed."""
        shared = {_storage_key(t) for t in ins}
        for t in tree_leaves(out):
            key = _storage_key(t)
            if key in shared or key in self._live:
                continue
            n = t.untyped_storage().nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def add_kernel(self, name: str, work: Work) -> None:
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += work["flops"]
        row["bytes"] += work["bytes"]
        self.flops += work["flops"]
        self.bytes += work["bytes"]


def active_counter() -> Optional[OpCounter]:
    """The innermost :class:`OpCounter` in effect, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def kernel(name: str, work: Callable[[], Work]) -> Iterator[None]:
    """One launch of the hand kernel ``name``, for the ``with`` body: the
    active counter, if any, adds ``work()`` (a formula of
    :mod:`repro_torch.launch.roofline`) once and counts no aten op run in the
    body (the plain version's, on the CPU).  Without a counter, nothing."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter.add_kernel(name, work())
    counter._quiet += 1
    try:
        yield
    finally:
        counter._quiet -= 1


def analyze_step(fn: Callable, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once and count its work on this rank.

    Returns the keys of the reference's ``analyze_hlo`` — ``flops``,
    ``bytes``, ``collective_bytes`` and ``coll_<kind>`` for every kind of
    ``roofline.COLLECTIVE_KINDS`` (and ``coll_other`` where one ran) — and
    also ``kernels`` (launches, FLOPs and bytes per hand kernel), ``ops``
    (per aten op), ``peak_bytes`` (the most bytes the step allocated and
    held at once), ``output_bytes`` (the local bytes of what ``fn``
    returned) and ``collective_counts``.
    """
    counter = OpCounter()
    with CollectiveRecorder() as rec, counter:
        out = fn(*args, **kwargs)
    coll = {k: float(rec.bytes.get(k, 0.0)) for k in COLLECTIVE_KINDS}
    coll.update({k: float(v) for k, v in rec.bytes.items() if k not in coll})
    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "collective_bytes": float(sum(coll.values())),
        **{f"coll_{k}": v for k, v in coll.items()},
        "collective_counts": dict(rec.counts),
        "kernels": counter.kernels,
        "ops": counter.ops,
        "peak_bytes": counter.peak_bytes,
        "output_bytes": local_bytes(out),
    }


def _tensors(tree: Any) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (the
    models' caches)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def local_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree of tensors, caches included: a
    ``DTensor`` leaf's local shard, any other tensor whole."""
    from repro_torch.sharding.utils import is_dtensor

    return sum(_nbytes(t.to_local() if is_dtensor(t) else t) for t in _tensors(tree))
