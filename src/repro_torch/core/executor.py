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

Left for later slices: the mesh path and its collective calibration, and
the adaptive gater.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import (
    Any, Callable, Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple,
)

import torch

from repro_torch._device import first_tensor, tree_leaves, tree_map
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import (
    BlockCost, ExecutionStats, NodeId, TaskGateRecord,
)

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
    """

    def __init__(self, program: MultitaskProgram, fused: bool = True):
        self.program = program
        self._fused = fused
        # (task, resume, batched, x_shape, x_dtype) -> (callable, mode); mode
        # is "scan" (one fn over a homogeneous suffix) or "unrolled".
        self._compiled_fused: Dict[Tuple, Tuple[Callable, str]] = {}
        # (task, start, stop, batched, x_shape, x_dtype) -> (callable, mode):
        # headless segment programs of checkpointed (intermittent) suffixes.
        self._compiled_segment: Dict[Tuple, Tuple[Callable, str]] = {}
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
        # The finished task's TaskGateRecord, and the per-task trace of the
        # last run/run_batch call.
        self.last_gate_record: Optional[TaskGateRecord] = None
        self.last_trace: List[TaskGateRecord] = []
        self.reset()

    @property
    def fused(self) -> bool:
        """Whether suffixes dispatch as single fused programs (vs. the
        per-block reference path).  Settable at any point between tasks —
        both paths produce identical counters and (allclose-)identical
        outputs."""
        return self._fused

    @fused.setter
    def fused(self, value: bool) -> None:
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

    # -------------------------------------------------------- fused suffix
    def _node_param(self, node: NodeId) -> Any:
        """A node's params: its committed streamed copy, if one exists."""
        streamed = self._streamed_node.get(node)
        if streamed is not None:
            return streamed
        return self.program.node_params[node]

    def _suffix_params(self, task: int, resume: int) -> Tuple[Any, ...]:
        return self._segment_params(task, resume, self.program.graph.depth)

    def _segment_params(self, task: int, start: int, stop: int) -> Tuple[Any, ...]:
        path = self.program.graph.path(task)
        return tuple(self._node_param(path[d]) for d in range(start, stop))

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
        """
        shape = tuple(shape)
        key = (task, resume, batched, shape, dtype)
        if key in self._compiled_fused:
            return self._compiled_fused[key]

        depth = self.program.graph.depth
        suffix = list(range(resume, depth))
        fns = [self._block_fn(d, batched) for d in suffix]
        head = self._head_fn(task, batched)
        mode = self._mode(
            suffix, self._suffix_params(task, resume), batched, shape, dtype)

        if mode == "scan":
            step_fn = fns[0]

            def fused(params_tuple, head_p, h):
                acts = []
                for p in params_tuple:
                    h = step_fn(p, h)
                    acts.append(h)
                return acts, head(head_p, h)

        else:

            def fused(params_tuple, head_p, h):
                acts = []
                for f, p in zip(fns, params_tuple):
                    h = f(p, h)
                    acts.append(h)
                return acts, head(head_p, h)

        self._compiled_fused[key] = (fused, mode)
        return fused, mode

    def _run_suffix_fused(
        self, task: int, resume: int, h: torch.Tensor, batched: bool
    ) -> torch.Tensor:
        """One dispatch for the whole (suffix + head) of ``task``."""
        graph = self.program.graph
        fn, _mode = self._fused_fn(task, resume, batched, tuple(h.shape), h.dtype)
        acts, out = fn(
            self._suffix_params(task, resume),
            self.program.head_params[task],
            h,
        )
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
        which owns the head)."""
        shape = tuple(shape)
        key = (task, start, stop, batched, shape, dtype)
        if key in self._compiled_segment:
            return self._compiled_segment[key]
        segment = list(range(start, stop))
        fns = [self._block_fn(d, batched) for d in segment]
        mode = self._mode(
            segment, self._segment_params(task, start, stop), batched, shape, dtype)

        if mode == "scan":
            step_fn = fns[0]

            def seg(params_tuple, h):
                acts = []
                for p in params_tuple:
                    h = step_fn(p, h)
                    acts.append(h)
                return acts

        else:

            def seg(params_tuple, h):
                acts = []
                for f, p in zip(fns, params_tuple):
                    h = f(p, h)
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
            acts = fn(self._segment_params(task, cur, d + 1), h)
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
        segmented fused path, so the unfused rung keeps journaling."""
        graph = self.program.graph
        path = graph.path(task)
        cuts = {d for d in checkpoint_depths if resume <= d < graph.depth - 1}
        for d in range(resume, graph.depth):
            node = path[d]
            h = self._block_fn(d, batched)(self._node_param(node), h)
            self.dispatch_count += 1
            self._activations[d] = h
            self._act_owner[d] = node
            if d in cuts and checkpoint_hook is not None:
                checkpoint_hook(d)
        out = self._head_fn(task, batched)(self.program.head_params[task], h)
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
    ) -> torch.Tensor:
        """Shared body of the single-request and batched task execution.

        The residency/resume/accounting invariants live ONLY here so the two
        paths cannot drift: ``weight`` is the logical request multiplicity
        scaling the per-request counters (flops/tasks), while load counters
        stay physical (once per invocation).  Accounting is dispatch-mode
        independent: the fused and per-block paths produce identical stats.
        """
        graph = self.program.graph
        path = graph.path(task)
        self._guard_act_shape(tuple(x.shape))

        # Deepest block of this task's path whose activation is cached.  The
        # task graph is a tree, so an owner match at depth ``d`` pins the
        # whole chain above it — contiguity below is not required, which is
        # what lets one restored crash checkpoint seed a mid-path resume.
        resume = 0
        for d, node in enumerate(path):
            if self._act_owner[d] == node and self._activations[d] is not None:
                resume = d + 1

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
            stats.flops_executed += weight * bc.flops
        stats.tasks_run += weight

        h = self._activations[resume - 1] if resume > 0 else x
        if self._fused:
            if checkpoint_depths:
                out = self._run_suffix_segmented(
                    task, resume, h, batched, checkpoint_depths, checkpoint_hook)
            else:
                out = self._run_suffix_fused(task, resume, h, batched)
        else:
            out = self._run_suffix_blocks(
                task, resume, h, batched, checkpoint_depths, checkpoint_hook)
        self.last_gate_record = TaskGateRecord(
            task=task, weight=weight, resume=resume
        )
        return out

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
        """
        w = int(xs.shape[0]) if weight is None else int(weight)
        return self._run_task_impl(
            task, xs, stats, w, batched=True,
            checkpoint_depths=checkpoint_depths,
            checkpoint_hook=checkpoint_hook,
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
