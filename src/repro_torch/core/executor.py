"""Block-cached task-graph executor (paper §2.3), the PyTorch port of
``repro.core.executor``.

* a *static buffer* holds one resident block per depth: before executing
  task ``t``, each block on ``t``'s path is loaded into its depth slot
  **unless it is already resident**;
* one *activation buffer per depth* caches the output of the most recently
  executed block at that depth, so a task sharing a prefix with the
  previously-run task resumes from the deepest shared block;
* tasks may be *skipped at runtime* by a gate over previously produced
  results (paper §4.3's conditional constraints).

Dispatch: by default each contiguous non-shared suffix (resume depth ->
head) runs as one **fused** program keyed like the reference's
``(task, resume, batched, input shape, dtype)`` — one dispatch per task.
A homogeneous suffix (same block fn, same parameter shapes,
shape-preserving) is mode "scan" and is driven as a loop of that one fn
over the suffix's parameters; any other suffix is mode "unrolled".  The mode
is chosen exactly as the reference chooses it, probing the block on meta
tensors where the reference uses ``jax.eval_shape``.  PyTorch runs eagerly,
so both modes are Python loops here; the key and mode are what a captured
CUDA graph per key will hang on.  ``fused=False`` keeps the per-block
reference path (one dispatch per block plus one for the head).  Both paths
produce identical counters.

Request groups run through :meth:`TaskGraphExecutor.run_batch`: a stacked
``(B, *sample)`` group executes every block once for the whole group.  The
reference vmaps each block over the request axis; here blocks are row-wise
over their leading sample axis (every block in the repository is), so the
request axis is folded into that axis — one natively batched op per block.
``ExecutionStats`` counters match ``GraphCostModel.predicted_stats`` (and
the reference executor) field for field.

Weight streaming: a :class:`WeightStreamer` per executor stages the next
group's non-resident block params behind the current group's compute.  On
CUDA each node's params are copied ``non_blocking`` from a pinned host copy
(built once, :meth:`WeightStreamer.prepare`) on a side stream, and the
compute stream waits on the copy's event when the executor commits it — the
analogue of the reference's asynchronous ``jax.device_put``.  A committed
copy backs that node's parameter lookups on every dispatch path (the port
has no stacked-parameter cache for its scan mode), so the staged bytes are
the bytes the kernels read.  On the CPU a stage is a plain synchronous copy.

Intermittent power: a checkpointed suffix is cut at cost-model-chosen block
depths into headless segment programs (:meth:`_segment_fn`); after each cut
a hook journals the freshly cached activation, and
:meth:`activation_checkpoint` / :meth:`restore_activation` let a rebooted
executor resume an interrupted suffix from the checkpoint depth instead of
0.

Input-adaptive gating: with a :class:`~repro_torch.adaptive.gating.\
BlockGater` every dispatched suffix (fused, segmented or per-block) gates
its shape-preserving blocks per request row.  As in the reference the gate
*masks*: every block runs for every row, and ``torch.where`` keeps the old
activation of a row whose confidence already cleared the threshold — so a
gated suffix launches exactly the kernels the ungated one does, and gating
saves modelled FLOPs (``flops_gated``), not device time.  The per-depth
thresholds live on the activation's device, one float32 tensor per
``(start, stop)`` refilled in place when the gater's threshold changes, and
are not part of any program key.  Each task's fire masks come back to the
host in one copy after its dispatches (one device sync per task, as the
reference's readback), and the realized counts split each executed block's
flops into fired and gated rows.

Mesh-sharded execution (``mesh=``, a ``DeviceMesh`` of the default process
group; every rank runs the same program in lockstep): parameters are placed
as ``DTensor``s by the sharding policy (``ShardingPolicy.param_spec``
fitted to the mesh; each rank keeps its own slice of the full tensors every
rank built from one seed, so placing issues no collective), each suffix
input is committed to the batch layout, and every block's output (and the
head's) is redistributed to it inside the fused suffix — the reference's
activation constraint.  ``DTensor`` inserts the collectives the layouts
need; plain tensors a block makes (positions, masks) count as replicated.
A dispatch's per-kind collective bytes come from one calibration run of the
same fused suffix on zeros of its input's shape, under a
:class:`~repro_torch.sharding.collectives.CollectiveRecorder`, cached under
the reference's key: the one dict both the counters and the cost model's
prediction (:meth:`TaskGraphExecutor.collective_view`) add.  Outputs and
fire masks come back as full tensors after each dispatch.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import (
    Any, Callable, Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch._device import first_tensor, tree_leaves, tree_map
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import (
    BlockCost, ExecutionStats, NodeId, TaskGateRecord,
)
from repro_torch.sharding.collectives import CollectiveRecorder
from repro_torch.sharding.policy import P, ShardingPolicy, TP_POLICY
from repro_torch.sharding.utils import fit_spec, place, placements

# What residency_state returns and what GraphCostModel.predicted_stats
# accepts as ``resume``.
ResidencyState = Tuple[Optional[NodeId], ...]

# block_fns[d](params, x) -> y  for depth-d blocks of the common architecture
BlockFn = Callable[[Any, torch.Tensor], torch.Tensor]
# head_fn(params, y) -> task output
HeadFn = Callable[[Any, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class MultitaskProgram:
    """A task graph bound to parameters and block semantics.

    Attributes:
      graph: the task graph.
      block_fns: per-depth apply function of the common architecture; each
        is row-wise over the leading axis of its input.
      node_params: parameters (dicts/lists of tensors) for every
        ``(depth, group)`` block node.
      head_fns / head_params: per-task classifier heads.
      block_costs: per-depth cost entries used for stats accounting.
    """

    graph: TaskGraph
    block_fns: Sequence[BlockFn]
    node_params: Dict[NodeId, Any]
    head_fns: Sequence[HeadFn]
    head_params: Sequence[Any]
    block_costs: Sequence[BlockCost]

    def __post_init__(self) -> None:
        for node in self.graph.nodes():
            if node not in self.node_params:
                raise ValueError(f"missing params for task-graph node {node}")

    @property
    def device(self) -> torch.device:
        """The device the program's parameters live on."""
        t = first_tensor(list(self.node_params.values()))
        return t.device if t is not None else torch.device("cpu")


def _leaf_specs(params: Any) -> Any:
    """Structure + leaf shapes/dtypes fingerprint for stackability checks."""
    if isinstance(params, torch.Tensor):
        return (tuple(params.shape), params.dtype)
    if isinstance(params, dict):
        return tuple((k, _leaf_specs(v)) for k, v in sorted(params.items()))
    if isinstance(params, (list, tuple)):
        return (type(params).__name__, tuple(_leaf_specs(v) for v in params))
    return repr(params)


def _row_batched(fn: Callable) -> Callable:
    """``fn`` over a stacked group ``(B, *sample)``: what
    ``jax.vmap(fn, in_axes=(None, 0))`` computes for a row-wise ``fn``.

    A sample of two or more axes carries its own leading row axis, into
    which the request axis folds (and unfolds after); a 1-D sample is a row
    already, so the group itself is the row batch.
    """

    def batched(params: Any, xs: torch.Tensor) -> torch.Tensor:
        if xs.dim() < 3:
            return fn(params, xs)
        return fn(params, xs.flatten(0, 1)).unflatten(0, xs.shape[:2])

    return batched


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _gate_bcast(fire: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reshape a per-row ``(B,)`` fire mask to broadcast against ``y``
    (``(B, ...)``) inside ``torch.where``; scalar masks broadcast as-is."""
    if fire.dim() == 0:
        return fire
    return fire.reshape(fire.shape + (1,) * (y.dim() - fire.dim()))


def _all_alive(h: torch.Tensor, batched: bool) -> torch.Tensor:
    """Every row of ``h`` alive: ``(B,)`` batched, a scalar unbatched."""
    return torch.ones(h.shape[:1] if batched else (), dtype=torch.bool,
                      device=h.device)


def _gate_block(
    y: torch.Tensor,
    h: torch.Tensor,
    alive: torch.Tensor,
    thr: torch.Tensor,
    conf_fn: Callable,
    early: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gate one block's output ``y`` over its input ``h``.

    A shape-preserving block fires for the rows that are still alive and
    whose confidence (of ``h``, compared as float32 with ``thr``) is below
    the threshold; the other rows keep ``h``.  ``early`` makes a row that
    did not fire dead for the rest of the suffix (early exit); otherwise
    every block re-decides (per block).  A shape-changing block cannot pass
    a row through, so it always fires.  This is both of the reference's
    masked variants — its ``lax.scan`` carry and its unrolled loop decide
    identically, since every block of a scan suffix is shape-preserving.
    Returns the gated output, the fire mask and the next alive mask.
    """
    if y.shape == h.shape and y.dtype == h.dtype:
        fire = alive & (conf_fn(h).float() < thr)
        return (torch.where(_gate_bcast(fire, y), y, h), fire,
                fire if early else alive)
    return y, torch.ones_like(alive), alive


def _stack_fired(fired: List[torch.Tensor], alive: torch.Tensor) -> torch.Tensor:
    """The ``(L, B)`` (``(L,)`` unbatched) fire masks of a suffix."""
    if not fired:
        return torch.zeros((0,) + tuple(alive.shape), dtype=torch.bool,
                           device=alive.device)
    return torch.stack(fired)


def _masked_blocks(
    fns: Sequence[Callable],
    params_tuple: Sequence[Any],
    thrs: torch.Tensor,
    h: torch.Tensor,
    conf_fn: Callable,
    early: bool,
    batched: bool,
    cst: Optional[Callable] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run ``fns`` over ``h``, each block gated per row (:func:`_gate_block`
    with ``thrs[i]``) and its output then passed through ``cst`` (the mesh's
    batch-layout constraint) when given.  Returns the per-depth activations
    and the fire masks."""
    alive = _all_alive(h, batched)
    acts: List[torch.Tensor] = []
    fired: List[torch.Tensor] = []
    for i, (f, p) in enumerate(zip(fns, params_tuple)):
        h, fire, alive = _gate_block(f(p, h), h, alive, thrs[i], conf_fn, early)
        if cst is not None:
            h = cst(h)
        acts.append(h)
        fired.append(fire)
    return acts, _stack_fired(fired, alive)


def _probe_output(
    fn: Callable, params: Any, shape: Tuple[int, ...], dtype: torch.dtype
) -> Optional[Tuple[Tuple[int, ...], torch.dtype]]:
    """Output shape/dtype of ``fn`` on meta tensors (the reference's
    ``jax.eval_shape``), or ``None`` when the fn cannot run abstractly.

    A block fn that reads tensor values (legal eagerly) cannot run on meta
    tensors, and PyTorch reports that with an error naming the meta device;
    that — like the reference's ``TypeError`` / ``ValueError`` /
    ``ConcretizationTypeError`` — means "not scannable".  Any other error is
    a real bug in the block fn and propagates.
    """
    meta_params = tree_map(lambda t: t.to("meta"), params)
    try:
        y = fn(meta_params, torch.empty(shape, dtype=dtype, device="meta"))
    except (TypeError, ValueError):
        return None
    except RuntimeError as err:
        if "meta" not in str(err):
            raise
        return None
    return tuple(y.shape), y.dtype


@dataclasses.dataclass
class ActivationCheckpoint:
    """A mid-suffix activation snapshot at a block-depth boundary.

    ``value`` is the cached activation of ``node`` (the block at ``depth``
    on the interrupted task's path) and ``act_shape`` the input-shape guard
    it was produced under.  Restoring it
    (:meth:`TaskGraphExecutor.restore_activation`) makes the next matching
    task resume from ``depth + 1`` instead of 0 — the paper's "an inference
    interrupted at block k must not restart from block 0" property.
    """

    depth: int
    node: NodeId
    value: Any
    act_shape: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class _Staged:
    """One node's staged copy: its params tree and, on CUDA, the event the
    side stream records after the copy."""

    params: Any
    done: Optional[Any] = None


class WeightStreamer:
    """Double-buffered asynchronous host->device weight stager.

    One staging slot per executor: :meth:`stage` issues copies of the
    *next* plan's non-resident block params, replacing any previous batch —
    stage(k+1) while executing k is the double buffer.

    On CUDA the source of each copy is a pinned host copy of the node's
    params, built once by :meth:`prepare` (``prepare_seconds`` and
    ``pinned_bytes`` say what it cost); the copies are issued
    ``non_blocking`` on a side :class:`torch.cuda.Stream`, so they overlap
    whatever the compute stream still runs, and each node's copy records an
    event.  On the CPU a copy is a synchronous ``clone``.

    Commit-on-use: a staged copy only becomes the executor's parameter for
    its node when the executor loads that node (:meth:`commit`, called from
    the load branch of ``_run_task_impl``): the compute stream then waits on
    the copy's event, and each tensor is marked as used on the compute
    stream (``record_stream``), so the caching allocator cannot hand its
    memory to a later stage while a kernel still reads it.  A committed
    copy lives while its node stays resident: the load that evicts the
    node drops it, so at most one path's params are streamed copies and
    one group's loads are staged on top of the program.  Until then
    nothing observable changes, so cancellation — :meth:`cancel` on a fresh
    stage, :meth:`invalidate` from ``TaskGraphExecutor.reset`` /
    ``set_residency`` — drops the staged copies and composes with the
    serving session's residency snapshot/rollback.  A dropped staged tensor
    was allocated and written on the side stream, so its memory goes back
    to that stream's pool and a later stage's copy is ordered after it.

    Stall accounting is modelled, not measured: the caller stages the batch
    with the cost model's residual (``GraphCostModel.prefetch_stall_seconds``)
    and :meth:`finish_group` returns it iff the group consumed any staged
    copy.  The copies' measured device time is telemetry only
    (:attr:`copy_log`, on CUDA), never an ``ExecutionStats`` counter.
    """

    #: stages kept in :attr:`copy_log`.
    COPY_LOG = 1024

    def __init__(self, executor: "TaskGraphExecutor"):
        self._executor = executor
        self._staged: Dict[NodeId, _Staged] = {}
        self._committed_since_stage = False
        #: Modelled stall (seconds) of the pending staged batch.
        self.pending_stall_seconds = 0.0
        # Lifetime telemetry (not part of ExecutionStats).
        self.prefetches = 0
        self.staged_bytes = 0.0
        self.committed_bytes = 0.0
        self.cancels = 0
        # CUDA only: the pinned host source of every node's params, the side
        # stream, and per stage (tensor bytes copied, start event, end event).
        self._host: Optional[Dict[NodeId, Any]] = None
        self._stream: Optional[Any] = None
        self.pinned_bytes = 0
        self.prepare_seconds = 0.0
        self.copy_log: Deque[Tuple[int, Any, Any]] = collections.deque(
            maxlen=self.COPY_LOG)

    @property
    def on_cuda(self) -> bool:
        return self._executor.program.device.type == "cuda"

    #: byte alignment of each leaf inside the pinned buffer.
    PIN_ALIGN = 512

    def prepare(self) -> None:
        """Build the pinned host source of every node's params and the side
        stream (CUDA only, once; a no-op on the CPU and when built).

        All leaves live in one pinned buffer, each at a ``PIN_ALIGN``-byte
        offset: the host allocator rounds every pinned allocation up to a
        power of two, so one buffer wastes at most that rounding once
        instead of once per leaf.
        """
        if not self.on_cuda or self._host is not None:
            return
        t0 = time.perf_counter()
        program = self._executor.program
        self._stream = torch.cuda.Stream(device=program.device)
        align = self.PIN_ALIGN
        total = 0
        for params in program.node_params.values():
            for t in tree_leaves(params):
                total += -(-t.numel() * t.element_size() // align) * align
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        offset = 0

        def pinned(t: torch.Tensor) -> torch.Tensor:
            nonlocal offset
            nbytes = t.numel() * t.element_size()
            view = buf[offset:offset + nbytes].view(t.dtype).view(t.shape)
            view.copy_(t)
            offset += -(-nbytes // align) * align
            return view

        self._host = {node: tree_map(pinned, params)
                      for node, params in program.node_params.items()}
        self.pinned_bytes = total
        self.prepare_seconds = time.perf_counter() - t0

    def staged_nodes(self) -> FrozenSet[NodeId]:
        """Nodes with a staged (uncommitted) copy in flight."""
        return frozenset(self._staged)

    def _copy(self, node: NodeId) -> _Staged:
        params = self._executor.program.node_params[node]
        if not self.on_cuda:
            return _Staged(tree_map(lambda t: t.clone(), params))
        self.prepare()
        side = self._stream
        with torch.cuda.stream(side):
            copy = tree_map(
                lambda h: torch.empty_like(h, device=side.device).copy_(
                    h, non_blocking=True),
                self._host[node],
            )
            done = torch.cuda.Event()
            done.record(side)
        return _Staged(copy, done)

    def stage(
        self,
        loads: Sequence[Tuple[int, NodeId]],
        stall_seconds: float = 0.0,
    ) -> None:
        """Issue copies for ``loads`` (``GraphCostModel.plan_loads``
        entries), replacing any previously staged batch."""
        self.cancel()
        ex = self._executor
        start = None
        if loads and self.on_cuda:
            self.prepare()
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
        nbytes = 0
        for depth, node in loads:
            staged = self._copy(node)
            self._staged[node] = staged
            nbytes += sum(t.numel() * t.element_size()
                          for t in tree_leaves(staged.params))
            self.staged_bytes += ex.program.block_costs[depth].weight_bytes
        if loads:
            self.prefetches += 1
            self.pending_stall_seconds = float(stall_seconds)
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(self._stream)
                self.copy_log.append((nbytes, start, end))

    def commit(self, node: NodeId) -> bool:
        """Adopt ``node``'s staged copy as its parameters, if one exists.

        Called exactly where the executor accounts a weight load; ``True``
        means the load's bytes arrived via the prefetch stream (the caller
        counts them in ``ExecutionStats.prefetched_bytes``).
        """
        staged = self._staged.pop(node, None)
        if staged is None:
            return False
        ex = self._executor
        if staged.done is not None:
            compute = torch.cuda.current_stream(ex.program.device)
            compute.wait_event(staged.done)
            for t in tree_leaves(staged.params):
                t.record_stream(compute)
        ex._streamed_node[node] = staged.params
        self._committed_since_stage = True
        self.committed_bytes += ex.program.block_costs[node[0]].weight_bytes
        return True

    def finish_group(self) -> float:
        """Close out the staged batch after its group ran: its modelled
        stall when the group committed any of it, else ``0.0``; uncommitted
        leftovers are dropped."""
        stall = (
            self.pending_stall_seconds if self._committed_since_stage else 0.0
        )
        self._staged.clear()
        self.pending_stall_seconds = 0.0
        self._committed_since_stage = False
        return stall

    def cancel(self) -> None:
        """Drop the staged (uncommitted) batch and its pending stall."""
        if self._staged or self.pending_stall_seconds:
            self.cancels += 1
        self._staged.clear()
        self.pending_stall_seconds = 0.0
        self._committed_since_stage = False

    def invalidate(self) -> None:
        """Cancel staging *and* drop committed copies: after a rollback or
        cold reset no streamed state may outlive the residency it was
        planned against."""
        self.cancel()
        self._executor._streamed_node.clear()


class TaskGraphExecutor:
    """Stateful executor with block residency + activation caching.

    Args:
      program: the bound multitask program.
      fused: execute each non-shared suffix as one fused program (default);
        ``False`` selects the per-block reference dispatch path.
      mesh: optional ``DeviceMesh`` for sharded execution: the batch
        dimension shards over the policy's batch axes, parameters over its
        ``model``/``fsdp`` axes (``ShardingPolicy.param_spec``), and
        activations are redistributed to the batch layout after every block
        of a fused suffix — so the executed suffix is the one the
        collective calibration measures.  Requires the fused path.  Placed
        parameters bypass the weight streamer's committed copies (the
        values are the same; the counters do not change).
      sharding: logical->physical axis policy; defaults to ``TP_POLICY``
        when a mesh is given.
      gater: optional :class:`~repro_torch.adaptive.gating.BlockGater`
        making execution input-conditional: shape-preserving blocks of every
        dispatched suffix keep their output only for the batch rows whose
        confidence is still below the gater's threshold (skipped rows pass
        their activation through unchanged), and the realized per-(block,
        row) fire counts land in ``ExecutionStats`` (``block_rows_fired`` /
        ``flops_gated``) and :attr:`last_gate_record`.  Program keys gain
        the gater's mode and confidence fn, never its threshold.
    """

    def __init__(
        self,
        program: MultitaskProgram,
        fused: bool = True,
        gater: Optional[Any] = None,
        mesh: Optional[Any] = None,
        sharding: Optional[ShardingPolicy] = None,
    ):
        self.program = program
        self._fused = fused
        self.gater = gater
        if mesh is not None and not fused:
            raise ValueError(
                "mesh-sharded execution requires the fused dispatch path "
                "(fused=True)"
            )
        self.mesh = mesh
        self.sharding: Optional[ShardingPolicy] = (
            sharding if sharding is not None
            else (TP_POLICY if mesh is not None else None)
        )
        # Mesh-placed parameter copies (input-independent; survive reset).
        self._placed_node: Dict[NodeId, Any] = {}
        self._placed_head: Dict[int, Any] = {}
        # Calibration caches: suffix-input shapes, and the per-kind
        # collective bytes each suffix dispatch adds to the counters.
        self._suffix_in: Dict[Tuple, Tuple[Tuple[int, ...], torch.dtype]] = {}
        self._coll_bytes: Dict[Tuple, Dict[str, float]] = {}
        #: calibration runs made (one per new collective-cache key).
        self.calibrations = 0
        # (task, resume, batched, x_shape, x_dtype, gate key) -> (callable,
        # mode); mode is "scan" (one fn over a homogeneous suffix) or
        # "unrolled".
        self._compiled_fused: Dict[Tuple, Tuple[Callable, str]] = {}
        # (task, start, stop, batched, x_shape, x_dtype, gate key) ->
        # (callable, mode): headless segment programs of checkpointed
        # (intermittent) suffixes.
        self._compiled_segment: Dict[Tuple, Tuple[Callable, str]] = {}
        # (start, stop, device) -> (thresholds held, float32 tensor): the
        # gater's per-depth thresholds on the activation's device.
        self._thresholds: Dict[Tuple, Tuple[Tuple[float, ...], torch.Tensor]] = {}
        # Streamed-and-committed parameter copies, value-identical to
        # program.node_params, dropped at every residency boundary.
        self._streamed_node: Dict[NodeId, Any] = {}
        # The double-buffered weight prefetcher (serving engines drive it
        # when EnginePolicy.streaming is on; idle otherwise).
        self.streamer = WeightStreamer(self)
        # Program dispatches (fused suffix or block/head calls).  Cumulative;
        # not part of ExecutionStats (those are cost-model-predictable
        # logical counters — dispatches depend on the dispatch mode).
        self.dispatch_count = 0
        # Adaptive gating: the current task's fire masks (``(start depth,
        # bool tensor)`` fragments, one per dispatched segment), the finished
        # task's TaskGateRecord, and the per-task trace of the last
        # run/run_batch call.
        self._fired_frags: List[Tuple[int, torch.Tensor]] = []
        self.last_gate_record: Optional[TaskGateRecord] = None
        self.last_trace: List[TaskGateRecord] = []
        # Fire-mask readbacks (one device-to-host copy per gated task) and
        # the host seconds spent waiting in them.  Telemetry, not counters.
        self.gate_readbacks = 0
        self.gate_readback_seconds = 0.0
        self.reset()

    def _gate_key(self) -> Optional[Tuple]:
        """Program-cache discriminator for the active gater: its mode and
        confidence fn, so swapping either never reuses a program built for
        other gate semantics.  Threshold changes do NOT change the key."""
        if self.gater is None:
            return None
        return (self.gater.mode, self.gater.confidence_fn)

    def _confidence(self, batched: bool) -> Callable:
        """The gater's row confidence over a group (``torch.vmap`` over the
        request axis, the reference's ``jax.vmap``) or one request.  On a
        mesh it runs per rank on the local rows of the batch layout."""
        fn = self.gater.confidence_fn
        fn = torch.vmap(fn) if batched else fn
        if self.mesh is None:
            return fn
        from torch.distributed.tensor.experimental import local_map

        def conf(h: Any) -> Any:
            layout = placements(self._batch_spec(tuple(h.shape), batched), self.mesh)
            return local_map(
                fn, out_placements=[*layout], in_placements=(layout,),
                device_mesh=self.mesh, redistribute_inputs=True,
            )(h)

        return conf

    @property
    def fused(self) -> bool:
        """Whether suffixes dispatch as single fused programs (vs. the
        per-block reference path).  Settable at any point between tasks —
        both paths produce identical counters and (allclose-)identical
        outputs.  Mesh-sharded executors require the fused path and reject
        ``False``."""
        return self._fused

    @fused.setter
    def fused(self, value: bool) -> None:
        if not value and self.mesh is not None:
            raise ValueError(
                "mesh-sharded execution requires the fused dispatch path; "
                "cannot set fused=False on a mesh executor"
            )
        self._fused = bool(value)

    # ---------------------------------------------------------------- state
    def reset(self) -> None:
        """Cold state: nothing resident, nothing cached, nothing streamed."""
        depth = self.program.graph.depth
        self._resident: List[Optional[NodeId]] = [None] * depth
        self.streamer.invalidate()
        self.clear_activations()

    def clear_activations(self) -> None:
        """Drop cached activations but keep weight residency (warm start).

        The whole-order entry points (:meth:`run` / :meth:`run_batch`) call
        this on entry so a new input never resumes from a previous input's
        activations, while the resident blocks remain loaded.  Callers
        driving :meth:`run_task` / :meth:`run_task_batch` directly own this
        contract themselves.
        """
        depth = self.program.graph.depth
        self._activations: List[Optional[torch.Tensor]] = [None] * depth
        self._act_owner: List[Optional[NodeId]] = [None] * depth
        self._act_shape: Optional[Tuple[int, ...]] = None

    def residency_state(self) -> ResidencyState:
        """Per-depth resident blocks, for warm-start cost accounting
        (``GraphCostModel.predicted_stats(..., resume=state)``)."""
        return tuple(self._resident)

    def set_residency(self, state: Sequence[Optional[NodeId]]) -> None:
        """Restore a residency snapshot (rollback / replay helper).

        Activations are always cleared — they belong to a specific input,
        which a snapshot does not carry — and any in-flight prefetch is
        cancelled and committed streamed copies dropped
        (:meth:`WeightStreamer.invalidate`): a restore is the rollback
        boundary, after which the next attempt loads synchronously and stays
        counter-exact.
        """
        depth = self.program.graph.depth
        if len(state) != depth:
            raise ValueError(
                f"residency state has {len(state)} slots, expected {depth}"
            )
        self._resident = list(state)
        self.streamer.invalidate()
        self.clear_activations()

    def activation_checkpoint(self, task: int) -> Optional[ActivationCheckpoint]:
        """Snapshot the deepest cached activation along ``task``'s path.

        What the serving journal persists at a segmented suffix's commit
        points: one ``(depth, node, value)`` triple resumes the interrupted
        suffix, because the task graph is a tree — the node pins the whole
        prefix chain that produced the value.  ``None`` when nothing on the
        path is cached.
        """
        path = self.program.graph.path(task)
        best: Optional[int] = None
        for d, node in enumerate(path):
            if self._act_owner[d] == node and self._activations[d] is not None:
                best = d
        if best is None:
            return None
        return ActivationCheckpoint(
            depth=best,
            node=path[best],
            value=self._activations[best],
            act_shape=self._act_shape,
        )

    def restore_activation(self, ckpt: ActivationCheckpoint) -> None:
        """Re-seed the activation cache from a journaled crash checkpoint.

        All other activation slots are cleared (they did not survive the
        power failure); the next task sharing the checkpoint's node resumes
        from ``ckpt.depth + 1``.  The value moves to the program's device in
        its own dtype.  Call *after* :meth:`set_residency` — restoring
        residency clears activations.
        """
        self.clear_activations()
        self._activations[ckpt.depth] = torch.as_tensor(ckpt.value).to(
            self.program.device)
        self._act_owner[ckpt.depth] = ckpt.node
        self._act_shape = (
            tuple(ckpt.act_shape) if ckpt.act_shape is not None else None
        )

    def _guard_act_shape(self, shape: Tuple[int, ...]) -> None:
        """Invalidate cached activations produced for a different input shape
        (e.g. switching between the single-request and batched paths)."""
        if self._act_shape is not None and self._act_shape != shape:
            self.clear_activations()
        self._act_shape = shape

    # ------------------------------------------------- per-block (reference)
    def _block_fn(self, depth: int, batched: bool) -> Callable:
        fn = self.program.block_fns[depth]
        return _row_batched(fn) if batched else fn

    def _head_fn(self, task: int, batched: bool) -> Callable:
        fn = self.program.head_fns[task]
        return _row_batched(fn) if batched else fn

    # ------------------------------------------------------ mesh placement
    def _place_param_leaf(self, leaf: torch.Tensor) -> Any:
        """One parameter leaf as a ``DTensor`` in its policy layout."""
        shape = tuple(leaf.shape)
        spec = fit_spec(shape, self.sharding.param_spec(shape), self.mesh)
        return place(leaf, spec, self.mesh)

    def _node_param(self, node: NodeId) -> Any:
        """A node's params: placed on a mesh, else its committed streamed
        copy if one exists."""
        if self.mesh is None:
            streamed = self._streamed_node.get(node)
            if streamed is not None:
                return streamed
            return self.program.node_params[node]
        if node not in self._placed_node:
            self._placed_node[node] = tree_map(
                self._place_param_leaf, self.program.node_params[node])
        return self._placed_node[node]

    def _head_param(self, task: int) -> Any:
        if self.mesh is None:
            return self.program.head_params[task]
        if task not in self._placed_head:
            self._placed_head[task] = tree_map(
                self._place_param_leaf, self.program.head_params[task])
        return self._placed_head[task]

    def _batch_spec(self, shape: Tuple[int, ...], batched: bool) -> P:
        """The fitted spec of a batch-leading tensor (replicated when the
        tensor carries no batch axis, i.e. the single-request path)."""
        spec = P(self.sharding.physical("batch")) if batched else P()
        return fit_spec(shape, spec, self.mesh)

    def _commit(self, h: Any, batched: bool) -> Any:
        """``h`` in the batch layout: a plain tensor is placed (no
        collective), a ``DTensor`` redistributed (a no-op for activations
        the fused suffix already constrained)."""
        spec = self._batch_spec(tuple(h.shape), batched)
        if isinstance(h, torch.Tensor) and not _is_dtensor(h):
            return place(h, spec, self.mesh)
        return h.redistribute(self.mesh, placements(spec, self.mesh))

    def _act_constrainer(self, batched: bool) -> Optional[Callable]:
        """Redistribution pinning activations to the batch layout inside
        fused suffixes, so the executed suffix equals the calibrated one and
        cached activations never reshard on re-entry."""
        if self.mesh is None or not batched:
            return None
        return lambda y: self._commit(y, batched=True)

    def _on_mesh(self):
        """The context a mesh dispatch runs in: plain tensors a block makes
        (positions, masks, thresholds) count as replicated."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

    # -------------------------------------------------------- fused suffix

    def _suffix_params(self, task: int, resume: int) -> Tuple[Any, ...]:
        return self._segment_params(task, resume, self.program.graph.depth)

    def _segment_params(self, task: int, start: int, stop: int) -> Tuple[Any, ...]:
        path = self.program.graph.path(task)
        return tuple(self._node_param(path[d]) for d in range(start, stop))

    def _plain_params(self, task: int, start: int, stop: int) -> Tuple[Any, ...]:
        """The program's own (unplaced) params of blocks ``start .. stop-1``
        of ``task``'s path: what shape probes run on."""
        path = self.program.graph.path(task)
        return tuple(self.program.node_params[path[d]] for d in range(start, stop))

    def _mode(self, suffix: Sequence[int], params: Sequence[Any],
              batched: bool, shape: Tuple[int, ...], dtype: torch.dtype) -> str:
        """"scan" for a homogeneous suffix (two or more blocks, one block
        fn, one parameter layout, shape-preserving — checked on meta
        tensors), else "unrolled": the reference's mode rule."""
        base_fns = [self.program.block_fns[d] for d in suffix]
        if len(suffix) >= 2 and all(f is base_fns[0] for f in base_fns):
            if len({_leaf_specs(p) for p in params}) == 1:
                spec = _probe_output(
                    self._block_fn(suffix[0], batched), params[0], shape, dtype)
                if spec is not None and spec == (shape, dtype):
                    return "scan"
        return "unrolled"

    def _fused_fn(
        self,
        task: int,
        resume: int,
        batched: bool,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
    ) -> Tuple[Callable, str]:
        """Build (or fetch) the fused suffix program for one resume point.

        The program runs blocks ``resume .. depth-1`` plus the task head and
        returns ``(per-depth activations, head output)`` — the intermediate
        activations feed the activation cache so later tasks can still
        resume mid-path.  ``shape``/``dtype`` describe the suffix's input.

        With a gater the program takes the per-depth threshold tensor as
        well and returns a third output, the ``(L, B)`` (``(L,)``
        unbatched) boolean fire masks (:func:`_masked_blocks`).
        """
        shape = tuple(shape)
        key = (task, resume, batched, shape, dtype, self._gate_key())
        if key in self._compiled_fused:
            return self._compiled_fused[key]

        depth = self.program.graph.depth
        suffix = list(range(resume, depth))
        fns = [self._block_fn(d, batched) for d in suffix]
        head = self._head_fn(task, batched)
        mode = self._mode(
            suffix, self._plain_params(task, resume, depth), batched, shape, dtype)
        cst = self._act_constrainer(batched) or (lambda y: y)

        if self.gater is not None:
            conf_fn = self._confidence(batched)
            early = self.gater.mode == "early_exit"

            def fused(params_tuple, thrs, head_p, h):
                acts, fired = _masked_blocks(
                    fns, params_tuple, thrs, h, conf_fn, early, batched, cst)
                return acts, cst(head(head_p, acts[-1] if acts else h)), fired

        elif mode == "scan":
            step_fn = fns[0]

            def fused(params_tuple, head_p, h):
                acts = []
                for p in params_tuple:
                    h = cst(step_fn(p, h))
                    acts.append(h)
                return acts, cst(head(head_p, h))

        else:

            def fused(params_tuple, head_p, h):
                acts = []
                for f, p in zip(fns, params_tuple):
                    h = cst(f(p, h))
                    acts.append(h)
                return acts, cst(head(head_p, h))

        self._compiled_fused[key] = (fused, mode)
        return fused, mode

    def _suffix_thresholds(
        self, start: int, stop: int, device: torch.device
    ) -> torch.Tensor:
        """The gater's thresholds for blocks ``start .. stop-1`` as a float32
        tensor on ``device``: built once per ``(start, stop, device)``, and
        refilled in place (``fill_`` takes the value as a kernel argument, so
        nothing is copied from the host) when the threshold has changed."""
        values = self.gater.suffix_thresholds(start, stop)
        key = (start, stop, device)
        held = self._thresholds.get(key)
        if held is None:
            thrs = torch.tensor(values, dtype=torch.float32, device=device)
            self._thresholds[key] = (values, thrs)
            return thrs
        old, thrs = held
        if old != values:
            for i, (a, b) in enumerate(zip(old, values)):
                if a != b:
                    thrs[i].fill_(b)
            self._thresholds[key] = (values, thrs)
        return thrs

    def _run_suffix_fused(
        self, task: int, resume: int, h: torch.Tensor, batched: bool
    ) -> torch.Tensor:
        """One dispatch for the whole (suffix + head) of ``task``."""
        graph = self.program.graph
        fn, _mode = self._fused_fn(task, resume, batched, tuple(h.shape), h.dtype)
        params = self._suffix_params(task, resume)
        head_p = self._head_param(task)
        if self.gater is not None:
            acts, out, fired = fn(
                params, self._suffix_thresholds(resume, graph.depth, h.device),
                head_p, h)
            self._fired_frags.append((resume, fired))
        else:
            acts, out = fn(params, head_p, h)
        self.dispatch_count += 1
        path = graph.path(task)
        for a, d in zip(acts, range(resume, graph.depth)):
            self._activations[d] = a
            self._act_owner[d] = path[d]
        return out

    # ----------------------------------------------- segmented (checkpoint)
    def _segment_fn(
        self,
        task: int,
        start: int,
        stop: int,
        batched: bool,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
    ) -> Tuple[Callable, str]:
        """Build (or fetch) a *headless* fused program for blocks
        ``start .. stop-1`` of ``task``'s path: the segmented variant of
        :meth:`_fused_fn`.  A checkpointed suffix is cut at its commit
        depths, each cut dispatching one of these so the journal hook can
        run — and a power failure can strike — at the boundary between
        them.  Same mode rule as the full suffix; returns the per-depth
        activations only (the last segment runs through :meth:`_fused_fn`,
        which owns the head).

        With a gater the segment takes the threshold tensor and returns
        ``(acts, fired)``.  Each segment re-derives its alive mask from
        scratch: for shape-preserving passthrough gating a skipped row's
        activation — hence its confidence, hence its gate decision — is
        unchanged at the boundary, so the re-derived mask equals the one an
        uncut suffix would have carried.  That is also why crash recovery
        replays identical gate decisions."""
        shape = tuple(shape)
        key = (task, start, stop, batched, shape, dtype, self._gate_key())
        if key in self._compiled_segment:
            return self._compiled_segment[key]
        segment = list(range(start, stop))
        fns = [self._block_fn(d, batched) for d in segment]
        mode = self._mode(
            segment, self._plain_params(task, start, stop), batched, shape, dtype)
        cst = self._act_constrainer(batched) or (lambda y: y)

        if self.gater is not None:
            conf_fn = self._confidence(batched)
            early = self.gater.mode == "early_exit"

            def seg(params_tuple, thrs, h):
                return _masked_blocks(
                    fns, params_tuple, thrs, h, conf_fn, early, batched, cst)

        elif mode == "scan":
            step_fn = fns[0]

            def seg(params_tuple, h):
                acts = []
                for p in params_tuple:
                    h = cst(step_fn(p, h))
                    acts.append(h)
                return acts

        else:

            def seg(params_tuple, h):
                acts = []
                for f, p in zip(fns, params_tuple):
                    h = cst(f(p, h))
                    acts.append(h)
                return acts

        self._compiled_segment[key] = (seg, mode)
        return seg, mode

    def _run_suffix_segmented(
        self,
        task: int,
        resume: int,
        h: torch.Tensor,
        batched: bool,
        checkpoint_depths: Sequence[int],
        checkpoint_hook: Optional[Callable[[int], None]],
    ) -> torch.Tensor:
        """Checkpointed suffix: commit points at block-depth boundaries.

        Each checkpoint depth ``d`` in ``[resume, depth-1)`` ends a segment
        dispatch after block ``d``; the hook then fires with the activation
        for depth ``d`` freshly cached.  The remainder past the last cut
        runs through the ordinary fused program, so an uncut suffix is the
        non-intermittent path.  Counters never change — segmentation only
        adds dispatches.
        """
        graph = self.program.graph
        path = graph.path(task)
        cur = resume
        for d in sorted(set(checkpoint_depths)):
            if d < cur or d >= graph.depth - 1:
                continue  # already covered, or past the last cut point
            fn, _mode = self._segment_fn(
                task, cur, d + 1, batched, tuple(h.shape), h.dtype)
            params = self._segment_params(task, cur, d + 1)
            if self.gater is not None:
                acts, fired = fn(
                    params, self._suffix_thresholds(cur, d + 1, h.device), h)
                self._fired_frags.append((cur, fired))
            else:
                acts = fn(params, h)
            self.dispatch_count += 1
            for a, dd in zip(acts, range(cur, d + 1)):
                self._activations[dd] = a
                self._act_owner[dd] = path[dd]
            h = self._activations[d]
            if checkpoint_hook is not None:
                checkpoint_hook(d)
            cur = d + 1
        return self._run_suffix_fused(task, cur, h, batched)

    def _run_suffix_blocks(
        self,
        task: int,
        resume: int,
        h: torch.Tensor,
        batched: bool,
        checkpoint_depths: Sequence[int] = (),
        checkpoint_hook: Optional[Callable[[int], None]] = None,
    ) -> torch.Tensor:
        """Reference path: one dispatch per block plus one for the head.
        Checkpoint hooks fire at the same block-depth boundaries as the
        segmented fused path, so the unfused rung keeps journaling.  With a
        gater each block is gated as a fused suffix gates it
        (:func:`_gate_block`), one block per dispatch."""
        graph = self.program.graph
        path = graph.path(task)
        cuts = {d for d in checkpoint_depths if resume <= d < graph.depth - 1}
        gated = self.gater is not None
        if gated:
            conf_fn = self._confidence(batched)
            early = self.gater.mode == "early_exit"
            thrs = self._suffix_thresholds(resume, graph.depth, h.device)
            alive = _all_alive(h, batched)
            fired: List[torch.Tensor] = []
        for d in range(resume, graph.depth):
            node = path[d]
            y = self._block_fn(d, batched)(self._node_param(node), h)
            if gated:
                y, fire, alive = _gate_block(
                    y, h, alive, thrs[d - resume], conf_fn, early)
                fired.append(fire)
            h = y
            self.dispatch_count += 1
            self._activations[d] = h
            self._act_owner[d] = node
            if d in cuts and checkpoint_hook is not None:
                checkpoint_hook(d)
        if gated:
            self._fired_frags.append((resume, _stack_fired(fired, alive)))
        out = self._head_fn(task, batched)(self._head_param(task), h)
        self.dispatch_count += 1
        return out

    # ------------------------------------------------------------------ run
    def _run_task_impl(
        self,
        task: int,
        x: torch.Tensor,
        stats: ExecutionStats,
        weight: int,
        batched: bool,
        checkpoint_depths: Sequence[int] = (),
        checkpoint_hook: Optional[Callable[[int], None]] = None,
        row_mask: Optional[Any] = None,
    ) -> torch.Tensor:
        """Shared body of the single-request and batched task execution.

        The residency/resume/accounting invariants live ONLY here so the two
        paths cannot drift: ``weight`` is the logical request multiplicity
        scaling the per-request counters (flops/tasks), while load counters
        stay physical (once per invocation).  Accounting is dispatch-mode
        independent: the fused and per-block paths produce identical stats.

        With a gater the per-block flop accounting is deferred until after
        the dispatch: the fire masks are read back and each executed block's
        flops split into ``flops_executed`` (rows that fired) and
        ``flops_gated`` (rows whose gate skipped it).  Loads stay physical
        and ungated.  ``row_mask`` (batched only) marks which rows of ``x``
        are logically live — exactly ``weight`` of them; rows outside it
        (padding, or rows a per-request gate turned off) execute but never
        count.
        """
        graph = self.program.graph
        path = graph.path(task)
        self._guard_act_shape(tuple(x.shape))
        self._fired_frags = []

        # Deepest block of this task's path whose activation is cached.  The
        # task graph is a tree, so an owner match at depth ``d`` pins the
        # whole chain above it — contiguity below is not required, which is
        # what lets one restored crash checkpoint seed a mid-path resume.
        resume = 0
        for d, node in enumerate(path):
            if self._act_owner[d] == node and self._activations[d] is not None:
                resume = d + 1

        gated = self.gater is not None
        executed_costs: List[BlockCost] = []
        for d in range(graph.depth):
            node = path[d]
            bc = self.program.block_costs[d]
            if d < resume:
                # Shared prefix: weights resident AND activation cached ->
                # skip both the load and the execute.
                stats.blocks_skipped += 1
                stats.weight_bytes_skipped += bc.weight_bytes
                stats.flops_skipped += weight * bc.flops
                continue
            if self._resident[d] != node:
                # A committed copy is only worth its device memory while its
                # node is resident: the evicted node's goes (values are the
                # same either way, so this changes no result).
                self._streamed_node.pop(self._resident[d], None)
                if self.streamer.commit(node):
                    # The bytes still count as loaded, but arrived over the
                    # prefetch stream behind the previous group's compute.
                    stats.prefetched_bytes += bc.weight_bytes
                stats.weight_bytes_loaded += bc.weight_bytes
                self._resident[d] = node
            else:
                # Still resident (warm start across groups, or an intra-order
                # revisit): the load is skipped but the block must execute —
                # its input activation belongs to the current input.
                stats.weight_bytes_skipped += bc.weight_bytes
            stats.blocks_executed += 1
            if gated:
                executed_costs.append(bc)
            else:
                stats.flops_executed += weight * bc.flops
        stats.tasks_run += weight

        h = self._activations[resume - 1] if resume > 0 else x
        if self.mesh is not None:
            # Commit the suffix input to the batch layout (a no-op for
            # cached activations, which the fused suffix already
            # constrained) and account this dispatch's measured collective
            # traffic — physical, once per dispatch, like the load counters.
            h = self._commit(h, batched)
            stats.add_collectives(self.suffix_collective_bytes(
                task, resume, tuple(h.shape), h.dtype, batched))
        with self._on_mesh():
            if self._fused:
                if checkpoint_depths:
                    out = self._run_suffix_segmented(
                        task, resume, h, batched, checkpoint_depths, checkpoint_hook)
                else:
                    out = self._run_suffix_fused(task, resume, h, batched)
            else:
                out = self._run_suffix_blocks(
                    task, resume, h, batched, checkpoint_depths, checkpoint_hook)
        if _is_dtensor(out):
            out = out.full_tensor()
        if gated:
            fired_rows = self._collect_fired(weight, batched, row_mask)
            if len(fired_rows) != len(executed_costs):
                raise AssertionError(
                    f"gate readback covered {len(fired_rows)} blocks, "
                    f"expected {len(executed_costs)}"
                )
            for bc, f in zip(executed_costs, fired_rows):
                stats.flops_executed += f * bc.flops
                stats.flops_gated += (weight - f) * bc.flops
                stats.block_rows_fired += f
                stats.block_rows_gated += weight - f
            self.last_gate_record = TaskGateRecord(
                task=task, weight=weight, fired=tuple(fired_rows),
                resume=resume,
            )
        else:
            self.last_gate_record = TaskGateRecord(
                task=task, weight=weight, resume=resume
            )
        return out

    def _collect_fired(
        self, weight: int, batched: bool, row_mask: Optional[Any]
    ) -> List[int]:
        """Per executed block depth, how many live rows fired.

        The task's fire masks come back in one device-to-host copy (a
        device sync — the price of realized-count accounting) and are
        reduced over the logically live rows: ``row_mask`` when given, else
        the first ``weight`` rows (the scheduler pads at the tail), else the
        whole single request.
        """
        frags = [f.full_tensor() if _is_dtensor(f) else f
                 for _start, f in self._fired_frags if f.shape[0]]
        if not frags:
            return []
        t0 = time.perf_counter()
        masks = torch.cat(frags).cpu().numpy()
        self.gate_readback_seconds += time.perf_counter() - t0
        self.gate_readbacks += 1
        if not batched:
            return [int(bool(v)) * weight for v in masks]
        if row_mask is not None:
            live = np.asarray(row_mask, bool)
            return [int(np.count_nonzero(row & live)) for row in masks]
        return [int(np.count_nonzero(row[:weight])) for row in masks]

    def run_task(
        self, task: int, x: torch.Tensor, stats: ExecutionStats
    ) -> torch.Tensor:
        """Run one task, resuming from the deepest cached shared block."""
        return self._run_task_impl(task, x, stats, 1, batched=False)

    def run(
        self,
        x: torch.Tensor,
        order: Sequence[int],
        gate: Optional[Callable[[int, Dict[int, torch.Tensor]], bool]] = None,
    ) -> Tuple[Dict[int, torch.Tensor], ExecutionStats]:
        """Execute all tasks in ``order`` on input ``x``.

        Args:
          x: the shared input sample/batch, on the program's device.
          order: task permutation from the ordering solver.
          gate: optional runtime gate implementing conditional constraints —
            ``gate(task, results_so_far) -> bool``; a gated-off task is
            skipped entirely.

        Returns:
          (per-task outputs, execution stats).
        """
        self.clear_activations()  # never resume from a previous input
        results: Dict[int, torch.Tensor] = {}
        stats = ExecutionStats()
        self.last_trace = []
        for t in order:
            if gate is not None and not gate(t, results):
                stats.tasks_skipped += 1
                self.last_trace.append(TaskGateRecord(task=t, weight=0))
                continue
            results[t] = self.run_task(t, x, stats)
            self.last_trace.append(self.last_gate_record)
        return results, stats

    # ---------------------------------------------------------------- batch
    def run_task_batch(
        self,
        task: int,
        xs: torch.Tensor,
        stats: ExecutionStats,
        weight: Optional[int] = None,
        checkpoint_depths: Sequence[int] = (),
        checkpoint_hook: Optional[Callable[[int], None]] = None,
        row_mask: Optional[Any] = None,
    ) -> torch.Tensor:
        """Run one task for a stacked request group ``xs``: ``(B, *sample)``.

        Every block on the path is loaded (and its batched activation
        cached) **once per group**, so weight loads amortise over ``B``
        requests.  ``weight`` is the number of real requests this execution
        serves (defaults to ``B``; the engine passes the gate-fired count,
        the scheduler the unpadded count): flop/task counters scale by it,
        load counters stay physical.

        ``checkpoint_depths`` / ``checkpoint_hook`` select the segmented
        (intermittent) dispatch: the suffix is cut at those block-depth
        boundaries and the hook fires after each cut with the activation
        freshly cached — see :meth:`_run_suffix_segmented`.

        ``row_mask`` (optional ``(B,)`` bool) marks which rows are logically
        live for adaptive fire accounting — exactly ``weight`` of them; see
        :meth:`_run_task_impl`.
        """
        w = int(xs.shape[0]) if weight is None else int(weight)
        return self._run_task_impl(
            task, xs, stats, w, batched=True,
            checkpoint_depths=checkpoint_depths,
            checkpoint_hook=checkpoint_hook,
            row_mask=row_mask,
        )

    def run_batch(
        self,
        xs: torch.Tensor,
        order: Sequence[int],
        gate: Optional[Callable[[int, Dict[int, torch.Tensor]], bool]] = None,
        valid: Optional[int] = None,
    ) -> Tuple[Dict[int, torch.Tensor], ExecutionStats]:
        """Execute all tasks in ``order`` once for a stacked request group.

        Args:
          xs: ``(B, *sample_shape)`` stacked inputs, one row per request
            (rows ``valid:`` may be padding added by the scheduler).
          order: task permutation from the ordering solver.
          gate: optional group-wise gate, same signature as :meth:`run` but
            receiving *batched* results; a gated-off task is skipped for the
            whole group.
          valid: number of real (non-padding) leading rows used for logical
            per-request accounting; defaults to ``B``.

        Returns:
          (per-task batched outputs ``{task: (B, *out_shape)}``, stats),
          equal to ``GraphCostModel.predicted_stats(order, batch_size=valid,
          resume=state)`` where ``state`` was :meth:`residency_state` before
          this call.
        """
        self.clear_activations()  # never resume from a previous input
        v = int(xs.shape[0]) if valid is None else int(valid)
        results: Dict[int, torch.Tensor] = {}
        stats = ExecutionStats()
        self.last_trace = []
        for t in order:
            if gate is not None and not gate(t, results):
                stats.tasks_skipped += v
                self.last_trace.append(TaskGateRecord(task=t, weight=0))
                continue
            results[t] = self.run_task_batch(t, xs, stats, weight=v)
            self.last_trace.append(self.last_gate_record)
        return results, stats

    # ------------------------------------------- collective calibration
    def _suffix_input(
        self,
        task: int,
        resume: int,
        x_shape: Tuple[int, ...],
        dtype: torch.dtype,
        batched: bool,
    ) -> Tuple[Tuple[int, ...], torch.dtype]:
        """Shape and dtype of the fused suffix's input given the group input.

        For ``resume > 0`` the suffix consumes the cached activation at
        depth ``resume - 1``: blocks ``0 .. resume-1`` of the task's own
        path run on meta tensors (the reference's ``jax.eval_shape``; a
        shared prefix runs the same depth fns, so the shapes match whichever
        task produced the cache).  A prefix that cannot run on meta tensors
        (flash attention refuses them) runs once on zeros with the
        program's own parameters instead — off the mesh, so it issues no
        collective.
        """
        key = (task, resume, tuple(x_shape), dtype, batched)
        if key not in self._suffix_in:
            path = self.program.graph.path(task)
            spec: Optional[Tuple[Tuple[int, ...], torch.dtype]] = (tuple(x_shape), dtype)
            for d in range(resume):
                spec = _probe_output(
                    self._block_fn(d, batched), self.program.node_params[path[d]],
                    *spec)
                if spec is None:
                    break
            if spec is None:
                h = torch.zeros(x_shape, dtype=dtype, device=self.program.device)
                for d in range(resume):
                    h = self._block_fn(d, batched)(self.program.node_params[path[d]], h)
                spec = (tuple(h.shape), h.dtype)
            self._suffix_in[key] = spec
        return self._suffix_in[key]

    def _run_calibration(
        self,
        task: int,
        resume: int,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        batched: bool,
    ) -> Any:
        """Run the fused suffix that dispatches ``task`` from ``resume`` on
        zeros of its input's shape, committed to the batch layout, with the
        placed parameters — the program the dispatch runs — and return its
        outputs.  Residency, activations, gate records and counters are
        untouched; every rank runs it in lockstep, as every rank runs the
        same session."""
        fn, _mode = self._fused_fn(task, resume, batched, tuple(shape), dtype)
        h = self._commit(
            torch.zeros(shape, dtype=dtype, device=self.program.device), batched)
        params = self._suffix_params(task, resume)
        with self._on_mesh():
            if self.gater is not None:
                thrs = self._suffix_thresholds(
                    resume, self.program.graph.depth, self.program.device)
                return fn(params, thrs, self._head_param(task), h)
            return fn(params, self._head_param(task), h)

    def suffix_trace(
        self, task: int, resume: int, xs: Any, batched: bool = True
    ) -> Any:
        """Re-run the dispatch of ``task`` from depth ``resume`` for group
        input ``xs`` (the calibration run, without the recorder): the hook
        a test uses to measure that dispatch's collectives on its own."""
        shape, dtype = self._suffix_input(
            task, resume, tuple(xs.shape), xs.dtype, batched)
        return self._run_calibration(task, resume, shape, dtype, batched)

    def suffix_collective_bytes(
        self,
        task: int,
        resume: int,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        batched: bool = True,
    ) -> Dict[str, float]:
        """Measured per-kind collective bytes of one suffix dispatch.

        ``shape``/``dtype`` describe the suffix *input* (the activation at
        ``resume - 1``, or the group input when ``resume == 0``).  Cached per
        key — the one source both the executor's counters and the cost
        model's predictions add from, which is what makes
        ``session.stats == session.predicted`` exact on a mesh.
        """
        shape = tuple(shape)
        key = (task, resume, batched, shape, dtype, self._gate_key())
        if key not in self._coll_bytes:
            with CollectiveRecorder() as rec:
                self._run_calibration(task, resume, shape, dtype, batched)
            self.calibrations += 1
            self._coll_bytes[key] = rec.breakdown()
        return self._coll_bytes[key]

    def collective_view(
        self, xs: Any, batched: bool = True
    ) -> Optional["CollectiveView"]:
        """A :class:`CollectiveView` bound to group input ``xs``, for
        ``GraphCostModel.predicted_stats(..., collectives=view)``; ``None``
        without a mesh (one-device programs have no collectives)."""
        if self.mesh is None:
            return None
        return CollectiveView(self, tuple(xs.shape), xs.dtype, batched)


class CollectiveView:
    """Per-(task, resume) measured collective bytes for one batch shape.

    The ``CollectiveCosts`` implementation the cost model consumes: bound to
    a group's (padded) input shape, it resolves each ``(task, resume)`` to
    the suffix input's shape and returns the executor's cached breakdown —
    the exact dict execution adds.
    """

    def __init__(
        self,
        executor: TaskGraphExecutor,
        x_shape: Tuple[int, ...],
        dtype: torch.dtype,
        batched: bool = True,
    ):
        self._executor = executor
        self._x_shape = tuple(x_shape)
        self._dtype = dtype
        self._batched = bool(batched)

    def breakdown(self, task: int, resume: int) -> Dict[str, float]:
        shape, dtype = self._executor._suffix_input(
            task, resume, self._x_shape, self._dtype, self._batched)
        return self._executor.suffix_collective_bytes(
            task, resume, shape, dtype, self._batched)


class VanillaExecutor:
    """Baseline: independently-trained networks run back to back.

    No block is ever considered resident across tasks and no activation is
    reused — every task pays its full load + execute cost (the paper's
    "Vanilla" baseline).
    """

    def __init__(self, program: MultitaskProgram):
        self.program = program
        self._inner = TaskGraphExecutor(program)

    def run(
        self,
        x: torch.Tensor,
        order: Optional[Sequence[int]] = None,
        gate: Optional[Callable[[int, Dict[int, torch.Tensor]], bool]] = None,
    ) -> Tuple[Dict[int, torch.Tensor], ExecutionStats]:
        order = list(order) if order is not None else list(
            range(self.program.graph.num_tasks)
        )
        results: Dict[int, torch.Tensor] = {}
        stats = ExecutionStats()
        for t in order:
            if gate is not None and not gate(t, results):
                stats.tasks_skipped += 1
                continue
            self._inner.reset()  # forget residency + caches between tasks
            results[t] = self._inner.run_task(t, x, stats)
        return results, stats


def run_in_order(
    program: MultitaskProgram,
    x: torch.Tensor,
    order: Sequence[int],
    gate: Optional[Callable[[int, Dict[int, torch.Tensor]], bool]] = None,
) -> Tuple[Dict[int, torch.Tensor], ExecutionStats]:
    """One-shot convenience wrapper around :class:`TaskGraphExecutor`."""
    return TaskGraphExecutor(program).run(x, order, gate)
