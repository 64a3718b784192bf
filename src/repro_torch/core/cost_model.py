"""Switching-cost model (paper §4.1) and task-graph cost estimation.

A framework-free copy of ``repro.core.cost_model``, kept equal to it for the
terms the port serves: switching costs, warm-start loads, the expected-cost
matrix, the counter prediction the executor must match (cold, warm via
``resume``, crash-recovered via ``first_task_resume``, and conditioned on a
realized ``gate_trace``), the weight-streaming terms (:meth:`plan_loads`,
:meth:`prefetch_stall_seconds`, the overlapped loads of
:meth:`PlanPredictor.append`) and the checkpoint terms
(:meth:`plan_checkpoints` and the write costs it places).  The reference's
collective terms and its ``weight_shards`` divisor wait for the mesh slice;
the :class:`~repro_torch.core.types.ExecutionStats` fields they fill stay.

The cost matrix ``C`` has ``c[i, j]`` = additional cost of loading and
executing task ``j`` given that task ``i`` just ran: the blocks on ``j``'s
path that are *not* shared with ``i`` must be loaded into the fast tier and
executed; shared-prefix blocks are skipped entirely because the executor
caches both their weights (already resident) and their output activations
(paper §2.3).  Because all paths run the same common architecture, block
cost depends only on depth, and the matrix is symmetric — exactly the
paper's observation.

Costs can be measured in seconds or joules through a
:class:`~repro_torch.core.types.HardwareModel`; the unit-cost mode
(``hw=None``) reproduces the paper's Figure-4 example where every block
costs 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import (
    BlockCost, ExecutionStats, HardwareModel, NodeId, Residency,
    TaskGateRecord,
)


@dataclasses.dataclass(frozen=True)
class GraphCostModel:
    """Cost model for a task graph given per-depth block costs.

    Attributes:
      graph: the task graph.
      block_costs: length ``D + 1`` per-depth :class:`BlockCost` of the common
        architecture (derived from the model definition's FLOP/byte counters).
      hw: platform; ``None`` means abstract unit costs (1 load + 1 exec per
        block, as in the paper's Figure 4 walkthrough).
      metric: ``"time"`` or ``"energy"`` (paper evaluates both).
      gate_model: optional object with ``task_probability(task)`` and
        ``fire_probability(task, depth)`` — the default for the
        ``expected_*`` methods.  ``None`` makes them degenerate to the
        all-blocks floor.
    """

    graph: TaskGraph
    block_costs: Sequence[BlockCost]
    hw: Optional[HardwareModel] = None
    metric: str = "time"
    gate_model: Optional[Any] = None

    def block_cost(self, depth: int) -> float:
        """Load + execute cost of the depth-``depth`` block."""
        if self.hw is None:
            return 2.0  # 1 unit load + 1 unit exec, Figure-4 convention
        bc = self.block_costs[depth]
        if self.metric == "energy":
            return (
                self.hw.energy_joules(bc.flops, bc.act_bytes)
                + self.load_cost(depth)
            )
        return bc.exec_seconds(self.hw) + self.load_cost(depth)

    def task_cost(self, task: int) -> float:
        """Cold cost of running ``task`` with nothing cached."""
        return sum(self.block_cost(d) for d, _ in self.graph.path(task))

    def load_cost(self, depth: int) -> float:
        """Load-only component of :meth:`block_cost` (weight streaming).

        This is the part of a block's cost that warm starts can save: the
        execute part is always paid for a fresh input, but the load is
        skipped whenever the block is still resident from an earlier group.
        """
        if self.hw is None:
            return 1.0  # the Figure-4 unit-load convention
        bc = self.block_costs[depth]
        if self.metric == "energy":
            return self.hw.energy_joules(0.0, 2.0 * bc.weight_bytes)
        return bc.load_seconds(self.hw)

    def switching_cost(self, prev: int, nxt: int) -> float:
        """``c[prev, nxt]``: cost of the non-shared suffix of ``nxt``."""
        if prev == nxt:
            return 0.0
        shared = self.graph.shared_prefix_depth(prev, nxt)
        return sum(
            self.block_cost(d) for d in range(shared, self.graph.depth)
        )

    def warm_switching_cost(self, prev: int, nxt: int) -> float:
        """Load-only cost of starting ``nxt`` with ``prev``'s path resident.

        The inter-*group* analogue of :meth:`switching_cost`: across a group
        boundary activations never survive, so every block of ``nxt``
        executes — only the loads of the still-resident shared prefix are
        saved.  This is the edge weight of the group-ordering pass.
        """
        shared = self.graph.shared_prefix_depth(prev, nxt)
        return sum(self.load_cost(d) for d in range(shared, self.graph.depth))

    def resume_load_cost(self, resident: Residency, task: int) -> float:
        """Load cost of ``task``'s blocks not present in ``resident``.

        Generalises :meth:`warm_switching_cost` to an arbitrary residency
        snapshot (``TaskGraphExecutor.residency_state()``), e.g. the state a
        persistent engine carries between ``serve_batch`` calls.
        """
        path = self.graph.path(task)
        return sum(
            self.load_cost(d)
            for d in range(self.graph.depth)
            if resident[d] != path[d]
        )

    def cost_matrix(self) -> np.ndarray:
        """The full symmetric ``n x n`` cost matrix (Eq. 3)."""
        n = self.graph.num_tasks
        c = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            for j in range(n):
                if i != j:
                    c[i, j] = self.switching_cost(i, j)
        return c

    # ------------------------------------------------------- expected costs
    def expected_block_cost(
        self, task: int, depth: int, gate_model: Optional[Any] = None
    ) -> float:
        """Expected load + execute cost of ``task``'s depth-``depth`` block:
        ``p * (load + q * exec)`` under a gate model whose task runs with
        probability ``p`` and whose block fires for a fraction ``q`` of
        rows.  Without a model this is exactly :meth:`block_cost`."""
        gm = gate_model if gate_model is not None else self.gate_model
        if gm is None:
            return self.block_cost(depth)
        load = self.load_cost(depth)
        return gm.task_probability(task) * (
            load
            + gm.fire_probability(task, depth)
            * (self.block_cost(depth) - load)
        )

    def expected_switching_cost(
        self, prev: int, nxt: int, gate_model: Optional[Any] = None
    ) -> float:
        """Expected ``c[prev, nxt]``: the probability-weighted non-shared
        suffix of ``nxt`` (see :meth:`expected_block_cost`)."""
        if prev == nxt:
            return 0.0
        shared = self.graph.shared_prefix_depth(prev, nxt)
        return sum(
            self.expected_block_cost(nxt, d, gate_model)
            for d in range(shared, self.graph.depth)
        )

    def expected_resume_load_cost(
        self, resident: Residency, task: int, gate_model: Optional[Any] = None
    ) -> float:
        """Expected-cost analogue of :meth:`resume_load_cost`: the load
        bytes only move if the task dispatches at all, so the warm-start
        term scales by its execution probability."""
        gm = gate_model if gate_model is not None else self.gate_model
        base = self.resume_load_cost(resident, task)
        if gm is None:
            return base
        return gm.task_probability(task) * base

    def expected_cost_matrix(
        self, gate_model: Optional[Any] = None
    ) -> np.ndarray:
        """The ``n x n`` *expected* switching-cost matrix (generally
        asymmetric: it weights by the *destination* task's
        probabilities)."""
        gm = gate_model if gate_model is not None else self.gate_model
        n = self.graph.num_tasks
        c = np.zeros((n, n), dtype=np.float64)
        for i in range(n):
            for j in range(n):
                if i != j:
                    c[i, j] = self.expected_switching_cost(i, j, gm)
        return c

    # ----------------------------------------------------------- aggregates
    def order_cost(self, order: Sequence[int], cyclic: bool = False) -> float:
        """Total cost of executing all tasks in ``order``.

        First task pays its cold cost; every subsequent task pays the
        switching cost from its predecessor.  With ``cyclic=True`` the
        wrap-around switch is added (the ILP's Hamiltonian-cycle objective);
        the paper's fitness (Eq. 7) is the path version.
        """
        total = self.task_cost(order[0])
        for a, b in zip(order[:-1], order[1:]):
            total += self.switching_cost(a, b)
        if cyclic and len(order) > 1:
            total += self.switching_cost(order[-1], order[0])
        return total

    def storage_bytes(self) -> float:
        """Total weight bytes of the task graph (Table 4/5 'memory')."""
        total = 0.0
        for d, _g in self.graph.nodes():
            total += self.block_costs[d].weight_bytes
        return total

    def _predict_into(
        self,
        order: Sequence[int],
        batch_size: int,
        resident: List[Optional[NodeId]],
        stats: ExecutionStats,
        gate_trace: Optional[Sequence[TaskGateRecord]] = None,
        first_task_resume: int = 0,
    ) -> None:
        """One group's counter prediction, mutating ``resident``/``stats``.

        Mirrors ``TaskGraphExecutor._run_task_impl`` exactly: the first task
        of a group never resumes from activations (the executor clears them
        at every input/group boundary), but any block still resident in
        ``resident`` skips its load while still executing.  The one
        exception is crash recovery: ``first_task_resume`` is the resume
        depth of the order's *first* task when a journaled mid-suffix
        activation checkpoint was restored into the executor
        (``TaskGraphExecutor.restore_activation``) — blocks below it skip
        both load and execute, exactly as a shared prefix would.

        A restored checkpoint also punches a hole in the activation cache:
        depths *below* the checkpoint were never computed this boot, so a
        later task whose shared prefix with its predecessor ends below that
        floor finds no cached activation at all and resumes from 0 (the
        executor's deepest-match rule).  ``act_floor`` tracks the
        shallowest cached depth — ``first_task_resume - 1`` after a
        restore, and 0 again as soon as any task re-executes from the root.

        ``gate_trace`` replays a *realized* gate outcome (one
        :class:`TaskGateRecord` per order position, the executor's
        ``last_trace``): a ``weight == 0`` record is a task a ``gate=``
        callback skipped for the whole group — it never dispatched, so
        neither residency nor the activation walk advances past it — while a
        partial-weight record scales the per-request counters by the rows
        that ran.  Records carrying a ``resume`` are cross-checked against
        this walk's resume depth, so any prediction/execution divergence
        raises instead of silently mis-counting.
        """
        if gate_trace is not None and len(gate_trace) != len(order):
            raise ValueError(
                f"gate trace has {len(gate_trace)} records for "
                f"{len(order)} tasks"
            )
        prev: Optional[int] = None
        act_floor = max(int(first_task_resume) - 1, 0)
        for pos, t in enumerate(order):
            rec = gate_trace[pos] if gate_trace is not None else None
            if rec is not None and rec.task != t:
                raise ValueError(
                    f"gate trace record {pos} is for task {rec.task}, "
                    f"order has task {t}"
                )
            if rec is not None and rec.weight == 0:
                # Gated off for the whole group: never dispatched.
                stats.tasks_skipped += batch_size
                continue
            w = int(rec.weight) if rec is not None else batch_size
            path = self.graph.path(t)
            if prev is None:
                shared = int(first_task_resume)
            else:
                shared = self.graph.shared_prefix_depth(prev, t)
                if 0 < shared <= act_floor:
                    # The shared activation this resume needs sits below
                    # the restored checkpoint's floor — it never existed
                    # this boot, so the executor starts the task from 0.
                    shared = 0
            act_floor = min(act_floor, shared)
            if rec is not None and rec.resume is not None:
                if int(rec.resume) != shared:
                    raise ValueError(
                        f"gate trace resume {rec.resume} for task {t} "
                        f"diverges from the predicted resume {shared}"
                    )
            for d in range(self.graph.depth):
                bc = self.block_costs[d]
                if d < shared:
                    # Skipped prefix: the executor touches neither the
                    # weights nor the residency here.  After a checkpoint
                    # restore ``resident[d]`` may not equal ``path[d]`` —
                    # those weights were never loaded this boot, and
                    # leaving residency as-is predicts the later reload.
                    stats.blocks_skipped += 1
                    stats.weight_bytes_skipped += bc.weight_bytes
                    stats.flops_skipped += w * bc.flops
                else:
                    stats.blocks_executed += 1
                    if resident[d] == path[d]:
                        stats.weight_bytes_skipped += bc.weight_bytes
                    else:
                        stats.weight_bytes_loaded += bc.weight_bytes
                    stats.flops_executed += w * bc.flops
                    resident[d] = path[d]
            stats.tasks_run += w
            if rec is not None:
                stats.tasks_skipped += batch_size - w
            prev = t

    def predicted_stats(
        self,
        order: Sequence[int],
        batch_size: int = 1,
        resume: Optional[Residency] = None,
        gate_trace: Optional[Sequence[TaskGateRecord]] = None,
        first_task_resume: int = 0,
        checkpoints: Optional[Sequence["CheckpointSite"]] = None,
    ) -> ExecutionStats:
        """Counter-level prediction the executor must match exactly.

        With ``batch_size > 1`` this predicts the *batched* executor
        (``TaskGraphExecutor.run_batch`` serving ``batch_size`` stacked
        requests): block invocations and weight loads happen once per group
        (loads amortise across the batch), while flop and task counters
        scale per request.

        ``resume`` is an initial residency snapshot
        (``TaskGraphExecutor.residency_state()``) for *warm* starts: blocks
        already resident skip their loads but still execute (activations
        never cross a group boundary).  ``resume=None`` is the cold
        prediction.

        ``gate_trace`` conditions the prediction on a realized gate outcome
        (see :meth:`_predict_into`).

        ``first_task_resume`` predicts a crash-recovered group whose first
        task resumes from a restored activation checkpoint at that depth;
        ``checkpoints`` (a :meth:`plan_checkpoints` plan) adds the group's
        checkpoint-write counters, which the journaling engine accounts
        from the *same* plan — exact by construction.
        """
        resident: List[Optional[NodeId]] = (
            list(resume) if resume is not None else [None] * self.graph.depth
        )
        if len(resident) != self.graph.depth:
            raise ValueError(
                f"resume has {len(resident)} slots, expected {self.graph.depth}"
            )
        stats = ExecutionStats()
        self._predict_into(
            order, batch_size, resident, stats, gate_trace,
            first_task_resume=first_task_resume,
        )
        for site in checkpoints or ():
            stats.checkpoint_bytes += site.bytes
            stats.checkpoint_seconds += site.seconds
        return stats

    def predicted_group_stats(
        self,
        plan: Sequence[Tuple[Sequence[int], int]],
        resume: Optional[Residency] = None,
    ) -> ExecutionStats:
        """Cumulative prediction for a warm multi-group schedule.

        ``plan`` is the executed schedule: one ``(order, batch_size)`` entry
        per group, in execution sequence.  Residency carries from each group
        into the next — activations do not — so this predicts exactly what
        the warm-start engine's cumulative counters will be.  ``resume``
        seeds the initial residency.
        """
        predictor = self.plan_predictor(resume=resume)
        for order, batch_size in plan:
            predictor.append(order, int(batch_size))
        return predictor.stats

    def plan_predictor(
        self,
        resume: Optional[Residency] = None,
        carry_residency: bool = True,
    ) -> "PlanPredictor":
        """An incremental predictor for incrementally-admitted plans."""
        return PlanPredictor(self, resume=resume, carry_residency=carry_residency)

    def plan_loads(
        self,
        order: Sequence[int],
        resident: Optional[Residency] = None,
        gate_trace: Optional[Sequence[TaskGateRecord]] = None,
    ) -> List[Tuple[int, NodeId]]:
        """The ``(depth, node)`` weight loads executing ``order`` will issue.

        Walks the same residency simulation as :meth:`_predict_into`, but
        returns the exact load sequence — every block that is *not*
        resident when its task reaches it.  This is the prefetch schedule
        the :class:`~repro_torch.core.executor.WeightStreamer` stages for
        the next group: staging precisely this set makes the executor's
        ``prefetched_bytes`` equal the group's ``weight_bytes_loaded`` by
        construction.

        ``resident`` is the residency at the start of the plan (``None`` =
        cold).  The list is in execution order and free of duplicates: an
        order that *revisits* an evicted block (interleaved subtrees, e.g.
        ``[0, 3, 1]``) re-loads it — and ``predicted_stats`` counts those
        bytes twice — but the streamer stages one copy per node and the
        executor commits it at most once, so the schedule lists each node
        once, at its first load; the revisit loads synchronously on both
        the predicted and the executed side.  ``gate_trace`` drops the
        loads of tasks a gate skipped for the whole group.
        """
        state: List[Optional[NodeId]] = (
            list(resident) if resident is not None else [None] * self.graph.depth
        )
        if len(state) != self.graph.depth:
            raise ValueError(
                f"resident has {len(state)} slots, expected {self.graph.depth}"
            )
        if gate_trace is not None and len(gate_trace) != len(order):
            raise ValueError(
                f"gate trace has {len(gate_trace)} records for "
                f"{len(order)} tasks"
            )
        loads: List[Tuple[int, NodeId]] = []
        staged: set = set()
        prev: Optional[int] = None
        for pos, t in enumerate(order):
            if gate_trace is not None and gate_trace[pos].weight == 0:
                continue  # never dispatched: no loads, walk unchanged
            path = self.graph.path(t)
            shared = (
                self.graph.shared_prefix_depth(prev, t) if prev is not None else 0
            )
            for d in range(shared, self.graph.depth):
                if state[d] != path[d] and path[d] not in staged:
                    loads.append((d, path[d]))
                    staged.add(path[d])
                state[d] = path[d]
            prev = t
        return loads

    def prefetch_stall_seconds(
        self, depths: Sequence[int], overlap_seconds: float
    ) -> float:
        """Modelled stall of streaming ``depths``' loads behind a compute
        window of ``overlap_seconds``: whatever load time does not fit in
        the window the previous group's compute opens."""
        total = sum(self.load_cost(d) for d in depths)
        return max(total - max(overlap_seconds, 0.0), 0.0)

    # ------------------------------------------------------- checkpointing
    def checkpoint_bytes(self, depth: int, batch_size: int) -> float:
        """Durable bytes of checkpointing depth-``depth``'s activation for a
        ``batch_size``-request group (one activation row per request)."""
        return float(batch_size) * self.block_costs[depth].act_bytes

    def checkpoint_write_seconds(self, depth: int, batch_size: int) -> float:
        """Modelled seconds of writing that checkpoint to the durable tier
        (the slow tier weights stream from, so ``hw.load_seconds``; the
        unit convention, ``hw=None``, charges 1)."""
        if self.hw is None:
            return 1.0
        return self.hw.load_seconds(self.checkpoint_bytes(depth, batch_size))

    def _checkpoint_write_cost(self, depth: int, batch_size: int) -> float:
        """Write cost in this model's metric (seconds or joules)."""
        if self.hw is None:
            return 1.0
        if self.metric == "energy":
            return self.hw.energy_joules(
                0.0, self.checkpoint_bytes(depth, batch_size)
            )
        return self.checkpoint_write_seconds(depth, batch_size)

    def _block_reexec_cost(self, depth: int, batch_size: int) -> float:
        """Metric cost of re-executing one block after a power failure:
        compute only — residency and checkpoints survive the crash."""
        if self.hw is None:
            return 1.0
        bc = self.block_costs[depth]
        if self.metric == "energy":
            return self.hw.energy_joules(batch_size * bc.flops, 0.0)
        return self.hw.exec_seconds(batch_size * bc.flops)

    def plan_checkpoints(
        self,
        order: Sequence[int],
        batch_size: int = 1,
        first_task_resume: int = 0,
    ) -> List["CheckpointSite"]:
        """Cost-chosen mid-suffix activation-checkpoint placement.

        Walks the group's execution (the walk of :meth:`_predict_into`)
        accumulating the *re-execution* cost a power failure would incur
        since the last durable point, and emits a checkpoint after a block
        exactly when that cost has reached the checkpoint's own write cost:
        never spend more writing state than the state saves on replay.
        Sites land at block-depth boundaries strictly inside a task's
        executed suffix (never after its final block).  The journaling
        engine and the predictor consume the same plan, so
        ``checkpoint_bytes`` / ``checkpoint_seconds`` stay exact by
        construction.
        """
        sites: List[CheckpointSite] = []
        depth = self.graph.depth
        reexec = 0.0
        prev: Optional[int] = None
        # The activation-floor rule of ``_predict_into``.
        act_floor = max(int(first_task_resume) - 1, 0)
        for pos, t in enumerate(order):
            if prev is None:
                shared = int(first_task_resume)
            else:
                shared = self.graph.shared_prefix_depth(prev, t)
                if 0 < shared <= act_floor:
                    shared = 0
            act_floor = min(act_floor, shared)
            for d in range(shared, depth):
                reexec += self._block_reexec_cost(d, batch_size)
                if d >= depth - 1:
                    continue  # suffix boundary: commit/prefix takes over
                if reexec >= self._checkpoint_write_cost(d, batch_size):
                    sites.append(CheckpointSite(
                        pos=pos,
                        task=t,
                        depth=d,
                        bytes=self.checkpoint_bytes(d, batch_size),
                        seconds=self.checkpoint_write_seconds(d, batch_size),
                    ))
                    reexec = 0.0
            prev = t
        return sites

    def residency_after(
        self, order: Sequence[int], resident: Optional[Residency] = None
    ) -> Tuple[Optional[NodeId], ...]:
        """Residency left behind by executing ``order``.

        Every task's path covers all depths, so after a non-empty order the
        resident block at each depth belongs to the *last* executed task;
        an empty order leaves ``resident`` untouched.
        """
        if order:
            return tuple(self.graph.path(order[-1]))
        if resident is None:
            return (None,) * self.graph.depth
        return tuple(resident)


@dataclasses.dataclass(frozen=True)
class CheckpointSite:
    """One planned mid-suffix activation checkpoint.

    ``pos`` indexes the group's execution order, ``task``/``depth`` name the
    block-depth boundary the checkpoint follows (the executor cuts its fused
    suffix there and fires the journal hook), and ``bytes``/``seconds`` are
    the durable write's modelled cost — the exact values both the executed
    counters and the prediction add.
    """

    pos: int
    task: int
    depth: int
    bytes: float
    seconds: float


class PlanPredictor:
    """Incremental counter prediction for incrementally-admitted plans.

    The incremental form of :meth:`GraphCostModel.predicted_group_stats`:
    call :meth:`append` with each group's ``(order, batch_size)`` in
    execution sequence and the tracked residency carries group-to-group
    exactly as the warm engine's executor does.  ``carry_residency=False``
    re-predicts every group from a cold slate (the ``warm_start=False``
    engine's semantics).  ``stats`` is the cumulative prediction so far;
    :meth:`append` returns the per-group delta.
    """

    def __init__(
        self,
        model: GraphCostModel,
        resume: Optional[Residency] = None,
        carry_residency: bool = True,
    ):
        self.model = model
        self.carry_residency = carry_residency
        depth = model.graph.depth
        self._resident: List[Optional[NodeId]] = (
            list(resume) if resume is not None else [None] * depth
        )
        if len(self._resident) != depth:
            raise ValueError(
                f"resume has {len(self._resident)} slots, expected {depth}"
            )
        self.stats = ExecutionStats()
        self.groups = 0  # groups appended so far

    @property
    def residency(self) -> Tuple[Optional[NodeId], ...]:
        """The tracked residency after every appended group."""
        return tuple(self._resident)

    def append(
        self,
        order: Sequence[int],
        batch_size: int = 1,
        extra_tasks_skipped: int = 0,
        gate_trace: Optional[Sequence[TaskGateRecord]] = None,
        overlap_seconds: Optional[float] = None,
        first_task_resume: int = 0,
        checkpoints: Optional[Sequence[CheckpointSite]] = None,
    ) -> ExecutionStats:
        """Account one more admitted group; returns that group's delta.

        ``extra_tasks_skipped`` folds in schedule-level skips (engine tasks
        outside the group's requested subset) so the cumulative prediction
        matches the engine's counters field-for-field; ``gate_trace``
        conditions the delta on the group's realized gate outcome.

        ``overlap_seconds`` (not ``None``) predicts a *streamed* group: its
        loads were prefetched behind a compute window of that many seconds,
        so the delta's ``prefetched_bytes`` equals the staged loads' bytes
        and ``stream_stall_seconds`` is whatever part of their load time did
        not fit in the window.  ``first_task_resume`` and ``checkpoints``
        predict an intermittent-execution group: a crash-recovered group
        resuming its first task from a restored checkpoint, and the group's
        planned checkpoint writes.
        """
        if not self.carry_residency:
            self._resident = [None] * self.model.graph.depth
        loads = (
            self.model.plan_loads(order, self._resident, gate_trace=gate_trace)
            if overlap_seconds is not None
            else []
        )
        delta = ExecutionStats()
        self.model._predict_into(
            order, int(batch_size), self._resident, delta, gate_trace,
            first_task_resume=first_task_resume,
        )
        for site in checkpoints or ():
            delta.checkpoint_bytes += site.bytes
            delta.checkpoint_seconds += site.seconds
        if loads:
            delta.prefetched_bytes = sum(
                self.model.block_costs[d].weight_bytes for d, _node in loads
            )
            delta.stream_stall_seconds = self.model.prefetch_stall_seconds(
                [d for d, _node in loads], overlap_seconds
            )
        delta.tasks_skipped += int(extra_tasks_skipped)
        self.stats = self.stats.merge(delta)
        self.groups += 1
        return delta

