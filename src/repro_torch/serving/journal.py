"""Write-ahead serving journal for power-failure-atomic execution, the
PyTorch port of ``repro.serving.journal``.

Antler's flagship platform (a batteryless MSP430FR5994) loses power as a
matter of course; what survives is the FRAM.  This module is the serving
stack's FRAM: a small append-only **write-ahead journal** the session writes
*before* acting, so that after a whole-process power failure a fresh session
(:meth:`~repro_torch.serving.session.ServingSession.recover`) can rebuild

* the admission queue — every admitted request is journaled at submit;
* exactly-once responses — a group's outputs are journaled atomically at
  **commit**; a committed group is never re-run, an uncommitted one is;
* the executor's weight residency — committed alongside each group;
* mid-suffix progress — segmented suffixes write an **activation
  checkpoint** at cost-model-chosen block-depth boundaries, so an
  inference interrupted at block ``d`` resumes from ``d``, not from 0.

Replay (:meth:`Journal.replay`) is a pure, idempotent fold over the record
stream; duplicate commits for one group are ignored after the first, which
is the exactly-once guarantee.

Payloads are held on the host: a tensor (an output, a checkpointed
activation, a tensor input) is copied to the CPU in its own dtype — the
copy of a CUDA tensor waits for the stream, so the durable write is
complete before the call returns; numpy inputs are copied as they are.
:class:`MemoryJournalStore` keeps those copies (the simulation's FRAM: it
outlives the session object).  :class:`FileJournalStore` writes JSON lines,
fsync'd per record: numpy arrays as the reference writes them, and a tensor
as its raw bits (an integer view of the same width — bf16 as int16) with
its dtype, so every dtype, bf16 included, round-trips bit-exactly without
``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.core.types import ExecutionStats, NodeId

__all__ = [
    "Journal",
    "JournalState",
    "JournalStore",
    "MemoryJournalStore",
    "FileJournalStore",
]


# ------------------------------------------------------------------ stores
class JournalStore:
    """Append-only durable record store (the "FRAM" interface).

    ``append`` must be atomic at record granularity: a record is either
    durably present in ``records()`` after ``append`` returns, or absent —
    never torn.
    """

    def append(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def records(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class MemoryJournalStore(JournalStore):
    """In-memory store: the simulated nonvolatile tier.  Kept *outside* the
    session, it survives a simulated power failure as FRAM survives a real
    one, while the session (SRAM) is rebuilt from scratch."""

    def __init__(self) -> None:
        self._records: List[Dict[str, Any]] = []

    def append(self, record: Dict[str, Any]) -> None:
        self._records.append(record)

    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def __len__(self) -> int:
        return len(self._records)


class FileJournalStore(JournalStore):
    """JSON-lines file store, fsync'd per record (arrays and tensors as
    tagged leaves, decoded back on read)."""

    def __init__(self, path: str) -> None:
        self.path = str(path)

    def append(self, record: Dict[str, Any]) -> None:
        line = json.dumps(_encode(record), separators=(",", ":"))
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def records(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out: List[Dict[str, Any]] = []
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(_decode(json.loads(line)))
        return out


# A tensor dtype's same-width integer view, for its bits in JSON.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _tensor_bits(t: torch.Tensor) -> List[int]:
    if t.dtype == torch.bool or not (t.is_floating_point() or t.is_complex()):
        return t.reshape(-1).tolist()
    return t.contiguous().view(_BITS[t.element_size()]).reshape(-1).tolist()


def _from_bits(bits: List[int], dtype: torch.dtype, shape: List[int]) -> torch.Tensor:
    if dtype == torch.bool or not (dtype.is_floating_point or dtype.is_complex):
        return torch.tensor(bits, dtype=dtype).reshape(shape)
    size = torch.empty((), dtype=dtype).element_size()
    return torch.tensor(bits, dtype=_BITS[size]).view(dtype).reshape(shape)


def _encode(obj: Any) -> Any:
    """Recursively encode a record for JSON (arrays and tensors -> tagged
    leaves)."""
    if isinstance(obj, torch.Tensor):
        return {
            "__tensor__": {
                "dtype": str(obj.dtype).removeprefix("torch."),
                "shape": list(obj.shape),
                "bits": _tensor_bits(obj),
            }
        }
    if isinstance(obj, np.ndarray):
        return {
            "__ndarray__": {
                "dtype": obj.dtype.name,
                "shape": list(obj.shape),
                "data": obj.ravel().tolist(),
            }
        }
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _decode(obj: Any) -> Any:
    """Inverse of :func:`_encode` (JSON lists stay lists)."""
    if isinstance(obj, dict):
        if "__tensor__" in obj and len(obj) == 1:
            spec = obj["__tensor__"]
            return _from_bits(
                spec["bits"], getattr(torch, spec["dtype"]), spec["shape"])
        if "__ndarray__" in obj and len(obj) == 1:
            spec = obj["__ndarray__"]
            return np.asarray(
                spec["data"], dtype=np.dtype(spec["dtype"])
            ).reshape(spec["shape"])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


# ------------------------------------------------------------- (de)coding
def _encode_node(node: Optional[NodeId]) -> Optional[List[Any]]:
    if node is None:
        return None
    depth, group = node
    return [int(depth), [int(t) for t in group]]


def _decode_node(enc: Optional[Sequence[Any]]) -> Optional[NodeId]:
    if enc is None:
        return None
    depth, group = enc
    return (int(depth), tuple(int(t) for t in group))


def _as_host(value: Any) -> Any:
    """A host copy of a payload for journaling: a tensor on the CPU in its
    own dtype (a CUDA tensor's copy waits for its stream), anything else as
    a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return np.array(value)


# -------------------------------------------------------------- journal
class Journal:
    """The serving session's write-ahead journal over a pluggable store.

    Record kinds (in the order a healthy group produces them)::

        admit         request acknowledged (payload: input, tasks, SLOs)
        group_begin   group planned: members, execution order, valid rows
        checkpoint    mid-suffix activation at a block-depth commit point
        group_commit  outputs + counters + post-group residency, atomically
        request_failed  request reached a durable non-response outcome

    Writers call the typed methods; readers call :meth:`replay`.
    """

    def __init__(self, store: Optional[JournalStore] = None) -> None:
        self.store = store if store is not None else MemoryJournalStore()

    # -------------------------------------------------------------- writes
    def admit(
        self,
        seq: int,
        x: Any,
        tasks: Optional[Sequence[int]],
        deadline: Optional[float] = None,
        priority: int = 0,
        tenant: Optional[str] = None,
    ) -> None:
        self.store.append({
            "kind": "admit",
            "seq": int(seq),
            "x": _as_host(x),
            "tasks": None if tasks is None else [int(t) for t in tasks],
            "deadline": None if deadline is None else float(deadline),
            "priority": int(priority),
            "tenant": tenant,
        })

    def request_failed(self, seq: int) -> None:
        """A durable terminal non-response outcome (expired, shed, or the
        group ladder ran out): recovery must not resurrect this request."""
        self.store.append({"kind": "request_failed", "seq": int(seq)})

    def group_begin(
        self,
        group_id: int,
        seqs: Sequence[int],
        order: Sequence[int],
        valid: int,
    ) -> None:
        self.store.append({
            "kind": "group_begin",
            "group_id": int(group_id),
            "seqs": [int(s) for s in seqs],
            "order": [int(t) for t in order],
            "valid": int(valid),
        })

    def checkpoint(
        self,
        group_id: int,
        pos: int,
        task: int,
        depth: int,
        node: NodeId,
        value: Any,
        act_shape: Optional[Sequence[int]],
    ) -> None:
        """One mid-suffix activation checkpoint: the suffix of ``task`` (at
        position ``pos`` of the group's order) committed through block
        ``depth``."""
        self.store.append({
            "kind": "checkpoint",
            "group_id": int(group_id),
            "pos": int(pos),
            "task": int(task),
            "depth": int(depth),
            "node": _encode_node(node),
            "value": _as_host(value),
            "act_shape": (
                None if act_shape is None else [int(s) for s in act_shape]
            ),
        })

    def group_commit(
        self,
        group_id: int,
        seqs: Sequence[int],
        outputs: Sequence[Dict[int, Any]],
        residency: Sequence[Optional[NodeId]],
        stats: ExecutionStats,
    ) -> None:
        """Atomically commit one executed group: per-slot ``outputs``
        (aligned with ``seqs``), the executor's post-group ``residency`` and
        the group's executed ``stats`` in one record — recovery sees all of
        the group or none of it."""
        self.store.append({
            "kind": "group_commit",
            "group_id": int(group_id),
            "seqs": [int(s) for s in seqs],
            "outputs": [
                [[int(t), _as_host(v)] for t, v in sorted(slot.items())]
                for slot in outputs
            ],
            "residency": [_encode_node(n) for n in residency],
            "stats": dataclasses.asdict(stats),
        })

    # --------------------------------------------------------------- reads
    def replay(self) -> "JournalState":
        """Fold the record stream into recovered state, idempotently: the
        first ``group_commit`` per group wins, and an ``admit`` for an
        already-admitted seq is a no-op."""
        admitted: Dict[int, Dict[str, Any]] = {}
        terminal: Set[int] = set()
        responses: Dict[int, Dict[str, Any]] = {}
        committed: Set[int] = set()
        residency: Optional[List[Optional[NodeId]]] = None
        open_groups: Dict[int, Dict[str, Any]] = {}
        checkpoints: Dict[int, Dict[str, Any]] = {}
        next_group_id = 0
        for rec in self.store.records():
            kind = rec.get("kind")
            if kind == "admit":
                admitted.setdefault(int(rec["seq"]), rec)
            elif kind == "request_failed":
                terminal.add(int(rec["seq"]))
            elif kind == "group_begin":
                gid = int(rec["group_id"])
                next_group_id = max(next_group_id, gid + 1)
                if gid not in committed:
                    open_groups[gid] = rec
            elif kind == "checkpoint":
                gid = int(rec["group_id"])
                if gid not in committed:
                    checkpoints[gid] = rec
            elif kind == "group_commit":
                gid = int(rec["group_id"])
                next_group_id = max(next_group_id, gid + 1)
                if gid in committed:
                    continue  # duplicate commit: exactly-once, first wins
                committed.add(gid)
                open_groups.pop(gid, None)
                checkpoints.pop(gid, None)
                residency = [_decode_node(n) for n in rec["residency"]]
                stats = ExecutionStats(**rec["stats"])
                for slot, seq in enumerate(rec["seqs"]):
                    seq = int(seq)
                    terminal.add(seq)
                    responses.setdefault(seq, {
                        "group_id": gid,
                        "outputs": {
                            int(t): v for t, v in rec["outputs"][slot]
                        },
                        "stats": stats,
                        "group_size": len(rec["seqs"]),
                    })
            else:
                raise ValueError(f"unknown journal record kind {kind!r}")
        # The in-flight group: the *latest* begun-but-uncommitted group.
        inflight: Optional[Dict[str, Any]] = None
        if open_groups:
            inflight = open_groups[max(open_groups)]
        checkpoint = (
            checkpoints.get(int(inflight["group_id"])) if inflight else None
        )
        return JournalState(
            admitted=admitted,
            terminal=terminal,
            responses=responses,
            residency=residency,
            inflight=inflight,
            checkpoint=checkpoint,
            next_group_id=next_group_id,
        )


@dataclasses.dataclass
class JournalState:
    """What :meth:`Journal.replay` recovers from the record stream.

    ``pending_seqs`` is the derived admission backlog: admitted requests
    with no durable terminal outcome, in admission order — exactly what a
    recovering session must re-enqueue.
    """

    admitted: Dict[int, Dict[str, Any]]
    terminal: Set[int]
    responses: Dict[int, Dict[str, Any]]
    residency: Optional[List[Optional[NodeId]]]
    inflight: Optional[Dict[str, Any]]
    checkpoint: Optional[Dict[str, Any]]
    next_group_id: int

    @property
    def pending_seqs(self) -> List[int]:
        return [s for s in sorted(self.admitted) if s not in self.terminal]

    def checkpoint_node(self) -> Optional[NodeId]:
        if self.checkpoint is None:
            return None
        return _decode_node(self.checkpoint["node"])
