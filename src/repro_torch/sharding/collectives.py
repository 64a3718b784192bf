"""Measured collective bytes: the port's stand-in for
``repro.launch.hlo_cost.collective_breakdown``.

The reference reads a compiled suffix's collectives out of its
post-optimisation HLO text, because XLA's partitioner inserts them at
compile time.  The port runs eagerly: ``DTensor`` inserts its collectives
at dispatch time, as ``_c10d_functional`` ops on the local shards, and there
is no HLO to read.  So the bytes are measured instead:
:class:`CollectiveRecorder` is a ``TorchDispatchMode`` that lets every
``DTensor`` op desugar first and then sums the **result bytes on this rank**
of every ``_c10d_functional`` collective issued inside it, per kind, under
the reference's names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``; anything else ``other``) — the
names :meth:`~repro_torch.core.types.ExecutionStats.add_collectives` takes.
A collective over a group of one rank moves no bytes between devices and
counts 0.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import tree_leaves

#: The reference's collective kind names (``hlo_cost.COLLECTIVE_KINDS``).
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# Functional ops that are not collectives: waiting on a result, wrapping it.
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def collective_kind(op_name: str) -> str:
    """The reference's kind name of a ``_c10d_functional`` op."""
    for prefix, kind in (("all_gather", "all-gather"),
                         ("all_reduce", "all-reduce"),
                         ("reduce_scatter", "reduce-scatter"),
                         ("all_to_all", "all-to-all"),
                         ("permute", "collective-permute")):
        if op_name.startswith(prefix):
            return kind
    return "other"


def _group_size(args: Any) -> int:
    """The size of the process group a functional collective runs over: its
    group name is its last string argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


class CollectiveRecorder(TorchDispatchMode):
    """Sums, per kind, the result bytes on this rank of the collectives
    issued inside it (``with CollectiveRecorder() as rec: ...``).

    ``bytes`` holds the byte sums and ``counts`` the number of collectives
    of each kind, group-of-one collectives included; ``largest`` is the
    bytes of the largest single collective; :meth:`breakdown` is the
    ``{kind: bytes}`` dict of the kinds seen.
    """

    def __init__(self) -> None:
        super().__init__()
        self.bytes: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.largest = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor desugar into local ops and collectives first.
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            name = func._opname
            if name not in _NOT_COLLECTIVES:
                kind = collective_kind(name)
                nbytes = 0
                if _group_size(args) > 1:
                    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out))
                self.bytes[kind] = self.bytes.get(kind, 0.0) + float(nbytes)
                self.largest = max(self.largest, float(nbytes))
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return out

    def breakdown(self) -> Dict[str, float]:
        return dict(self.bytes)
