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

Left for later slices: the mesh path and its collective calibration, the
weight streamer, checkpoint segments, and the adaptive gater.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import first_tensor, tree_map
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
        """Cold state: nothing resident, nothing cached."""
        depth = self.program.graph.depth
        self._resident: List[Optional[NodeId]] = [None] * depth
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
        """Restore a residency snapshot; activations are always cleared —
        they belong to a specific input, which a snapshot does not carry."""
        depth = self.program.graph.depth
        if len(state) != depth:
            raise ValueError(
                f"residency state has {len(state)} slots, expected {depth}"
            )
        self._resident = list(state)
        self.clear_activations()

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
    def _suffix_params(self, task: int, resume: int) -> Tuple[Any, ...]:
        path = self.program.graph.path(task)
        return tuple(
            self.program.node_params[path[d]]
            for d in range(resume, self.program.graph.depth)
        )

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
        base_fns = [self.program.block_fns[d] for d in suffix]
        fns = [self._block_fn(d, batched) for d in suffix]
        head = self._head_fn(task, batched)

        mode = "unrolled"
        if len(suffix) >= 2 and all(f is base_fns[0] for f in base_fns):
            params = self._suffix_params(task, resume)
            if len({_leaf_specs(p) for p in params}) == 1:
                # Same fn + same param shapes; the scan also needs the carry
                # shape to be invariant — verified without executing.
                spec = _probe_output(fns[0], params[0], shape, dtype)
                if spec is not None and spec == (shape, dtype):
                    mode = "scan"

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

    def _run_suffix_blocks(
        self, task: int, resume: int, h: torch.Tensor, batched: bool
    ) -> torch.Tensor:
        """Reference path: one dispatch per block plus one for the head."""
        graph = self.program.graph
        path = graph.path(task)
        for d in range(resume, graph.depth):
            node = path[d]
            h = self._block_fn(d, batched)(self.program.node_params[node], h)
            self.dispatch_count += 1
            self._activations[d] = h
            self._act_owner[d] = node
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
        # whole chain above it.
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
            out = self._run_suffix_fused(task, resume, h, batched)
        else:
            out = self._run_suffix_blocks(task, resume, h, batched)
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
    ) -> torch.Tensor:
        """Run one task for a stacked request group ``xs``: ``(B, *sample)``.

        Every block on the path is loaded (and its batched activation
        cached) **once per group**, so weight loads amortise over ``B``
        requests.  ``weight`` is the number of real requests this execution
        serves (defaults to ``B``; the engine passes the gate-fired count,
        the scheduler the unpadded count): flop/task counters scale by it,
        load counters stay physical.
        """
        w = int(xs.shape[0]) if weight is None else int(weight)
        return self._run_task_impl(task, xs, stats, w, batched=True)

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
