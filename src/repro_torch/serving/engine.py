"""The multitask serving engine, the PyTorch port of
``repro.serving.engine.MultitaskEngine``.

The Antler runtime: a task graph + optimal order + the block-cached
executor, serving batched requests that each want some subset of the task
set.  Conditional constraints become runtime gates (a dependent task is
skipped when its prerequisite's outcome says so).

Long-lived serving goes through :meth:`MultitaskEngine.session` (a
:class:`~repro_torch.serving.session.ServingSession`: admission under a
scheduling policy, futures, deadlines, backpressure, and group recovery
with rollback, retries and the unfused rung); ``serve`` / ``serve_batch``
are one-shot sessions.  A :class:`~repro_torch.serving.reliability.\
FaultInjector` can fire at the ``"plan"``, ``"load"`` and ``"dispatch"``
boundaries.  :class:`LMServer` runs batched prefill and greedy decode.
Weight streaming, intermittent power, adaptive gating and the mesh wait for
later slices.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, FrozenSet, List, Optional, Sequence,
    Tuple,
)

import numpy as np
import torch

from repro_torch.core.constraints import Constraints
from repro_torch.core.cost_model import GraphCostModel
from repro_torch.core.executor import MultitaskProgram, TaskGraphExecutor
from repro_torch.core.ordering import optimal_order, solve_suborder
from repro_torch.core.types import (
    ExecutionStats, HardwareModel, TPU_V5E, TaskGateRecord,
)
from repro_torch.models.cache import EncDecCache, HybridCache, KVCache, SSMCache
from repro_torch.models.registry import ModelApi
from repro_torch.serving.batching import (
    RequestGroup, RequestGroupScheduler, effective_order, normalize_subset,
)
from repro_torch.serving.policies import EnginePolicy

if TYPE_CHECKING:  # session imports engine; keep the runtime import lazy
    from repro_torch.serving.policies import SchedulingPolicy
    from repro_torch.serving.reliability import FaultInjector
    from repro_torch.serving.session import ServingSession


@dataclasses.dataclass
class MultitaskRequest:
    """One inference request: an input (numpy or tensor), the tasks it
    wants, and its SLOs.

    The SLO fields are metadata the *session* layer acts on; the engine's
    execution path ignores them.  ``deadline`` is an absolute time on the
    session's clock by which the request must have been admitted for
    planning (a pump finding it overdue fails its future with
    :class:`~repro_torch.serving.reliability.DeadlineExceeded`).
    ``priority`` orders load shedding (higher wins) when a bounded session
    queue overflows.  ``tenant`` labels the request for per-tenant quota and
    admission-wait accounting.
    """

    x: Any
    tasks: Optional[Sequence[int]] = None  # None = all tasks
    deadline: Optional[float] = None       # session-clock absolute seconds
    priority: int = 0                      # higher survives shedding longer
    tenant: Optional[str] = None           # quota / wait-accounting label


@dataclasses.dataclass
class MultitaskResponse:
    """Engine reply for one request.

    ``stats`` are the counters of the *execution group* the request was
    served in (``group_size`` requests share one batched pass); each
    response carries its own copy.  ``predicted_seconds`` is this request's
    per-request share of the group's modelled cost as it actually ran;
    ``warm_weight_bytes_saved`` is the group's weight bytes not loaded
    because of cross-group residency alone.  ``order`` is the engine's
    global task order; ``effective_order`` the sequence the request's group
    actually ran.  ``retries`` counts the failed attempts before the one
    that produced this response; ``degraded`` names the recovery rung that
    succeeded (``"unfused"``: the per-block dispatch), ``None`` for the
    primary path.
    """

    outputs: Dict[int, torch.Tensor]
    stats: ExecutionStats
    order: Tuple[int, ...]
    predicted_seconds: float
    group_size: int = 1
    warm_weight_bytes_saved: float = 0.0
    effective_order: Tuple[int, ...] = ()
    retries: int = 0
    degraded: Optional[str] = None


@dataclasses.dataclass
class GroupExecution:
    """One executed request group.

    ``outputs`` holds the per-slot (valid rows only) task outputs; ``stats``
    the executed counters of this group alone; ``predicted`` the cost
    model's prediction for the same group from the executor's residency
    immediately before execution, conditioned on ``gate_trace`` (the
    realized per-task gate outcomes).
    """

    group: RequestGroup
    eff: Tuple[int, ...]
    outputs: List[Dict[int, torch.Tensor]]
    stats: ExecutionStats
    predicted: ExecutionStats
    warm_saved: float
    gate_trace: Optional[List[TaskGateRecord]] = None


@dataclasses.dataclass(frozen=True)
class _ConditionalProbabilities:
    """Task execution probabilities of conditional constraints (Eq. 8) in
    the cost model's gate-model interface — the reference's
    ``GateModel.from_constraints`` for an engine without adaptive gating."""

    constraints: Constraints

    def task_probability(self, task: int) -> float:
        return self.constraints.execution_probability(task)

    def fire_probability(self, task: int, depth: int) -> float:
        return 1.0


class MultitaskEngine:
    """Antler end-to-end: ordering solved once at startup, executor reused.

    ``gates``: {task: fn(outputs_so_far) -> bool} runtime conditions
    implementing conditional constraints; ``gate_deps`` declares which
    outputs each gate reads (derived from the conditional constraint edges
    when not given), which makes per-plan order re-solving sound.

    Schedule-shaped behaviour comes from one :class:`EnginePolicy`
    (``policy``); the ``warm_start`` / ``group_ordering`` / ``scheduler``
    keywords override its fields.  None of them change results, only how
    much gets loaded.  The engine runs on the program's device: each planned
    group moves there once.

    Long-lived serving goes through :meth:`session`; ``serve`` /
    ``serve_batch`` are thin wrappers that run a one-shot session.
    ``fault_injector`` (settable at any time) fires at the ``"plan"``,
    ``"load"`` and ``"dispatch"`` boundaries of group execution.
    """

    def __init__(
        self,
        program: MultitaskProgram,
        constraints: Optional[Constraints] = None,
        hw: HardwareModel = TPU_V5E,
        gates: Optional[Dict[int, Callable[[Dict[int, torch.Tensor]], bool]]] = None,
        gate_deps: Optional[Dict[int, Sequence[int]]] = None,
        order: Optional[Sequence[int]] = None,
        scheduler: Optional[RequestGroupScheduler] = None,
        warm_start: Optional[bool] = None,
        group_ordering: Optional[bool] = None,
        policy: Optional[EnginePolicy] = None,
        fault_injector: Optional["FaultInjector"] = None,
    ):
        self.program = program
        self.device = program.device
        self.hw = hw
        self.constraints = constraints
        self.gates = gates or {}
        policy = policy if policy is not None else EnginePolicy()
        overrides: Dict[str, Any] = {}
        if warm_start is not None:
            overrides["warm_start"] = bool(warm_start)
        if group_ordering is not None:
            overrides["group_ordering"] = bool(group_ordering)
        if scheduler is not None:
            overrides["scheduler"] = scheduler
        if overrides:
            policy = dataclasses.replace(policy, **overrides)
        if policy.scheduler is None:
            policy = dataclasses.replace(
                policy, scheduler=RequestGroupScheduler()
            )
        self.policy = policy
        # Which tasks each runtime gate reads: {gated_task: (input_tasks,)}.
        self.gate_deps: Dict[int, Tuple[int, ...]] = {}
        if gate_deps is not None:
            self.gate_deps = {
                int(t): tuple(int(i) for i in deps)
                for t, deps in gate_deps.items()
            }
        elif constraints is not None and self.gates:
            for t in self.gates:
                deps = tuple(sorted(
                    i for (i, j, _p) in constraints.conditional if j == t
                ))
                if deps:
                    self.gate_deps[t] = deps
        self._plan_constraints = self._build_plan_constraints(
            program.graph.num_tasks, constraints
        )
        self.cost_model = GraphCostModel(program.graph, program.block_costs, hw)
        self._cost_matrix = self.cost_model.cost_matrix()
        self._resolve_mat: Optional[np.ndarray] = None
        if order is None:
            # optimal_order applies the Eq.-8 conditional weighting itself.
            order = optimal_order(self._cost_matrix, constraints).order
        self.order = tuple(order)
        if constraints is not None and not constraints.is_valid_order(self.order):
            raise ValueError("supplied order violates the constraints")
        if (
            self._plan_constraints is not None
            and not self._plan_constraints.is_valid_order(self.order)
        ):
            raise ValueError(
                "gate_deps edges conflict with the engine's task order: a "
                "gate would read an output its order produces later"
            )
        self.executor = TaskGraphExecutor(program)
        self.fault_injector = fault_injector
        # Cumulative counters of the most recent serve_batch call (its
        # one-shot session's stats); with no gates and the default greedy
        # scheduling these equal predicted_group_stats(plan_groups(requests))
        # computed before that call.
        self.last_batch_stats = ExecutionStats()

    @property
    def warm_start(self) -> bool:
        return self.policy.warm_start

    @property
    def group_ordering(self) -> bool:
        return self.policy.group_ordering

    @property
    def scheduler(self) -> RequestGroupScheduler:
        return self.policy.scheduler

    def normalized_subset(
        self, tasks: Optional[Sequence[int]]
    ) -> Optional[FrozenSet[int]]:
        """A request's task subset in the scheduler's bucket-key form."""
        return normalize_subset(tasks, self.program.graph.num_tasks)

    def session(
        self,
        policy: Optional["SchedulingPolicy"] = None,
        clock: Optional[Callable[[], float]] = None,
        **kwargs: Any,
    ) -> "ServingSession":
        """Open a :class:`~repro_torch.serving.session.ServingSession` on
        this engine (``policy`` defaults to ``self.policy.scheduling``).
        Extra keyword arguments — ``max_pending``, ``overload``, ``retry``,
        ``sleep``, … — forward to the session constructor."""
        from repro_torch.serving.session import ServingSession

        return ServingSession(self, policy=policy, clock=clock, **kwargs)

    # ------------------------------------------------------------- planning
    def _build_plan_constraints(
        self, num_tasks: int, constraints: Optional[Constraints]
    ) -> Optional[Constraints]:
        """Constraints for per-plan re-solving: the engine's own, plus one
        precedence edge per declared gate input."""
        edges = {
            (i, t) for t, deps in self.gate_deps.items() for i in deps
        }
        base = constraints.precedence if constraints is not None else frozenset()
        if not (edges - set(base)):
            return constraints
        return Constraints.make(
            num_tasks,
            precedence=set(base) | edges,
            conditional=(
                constraints.conditional if constraints is not None else ()
            ),
        )

    def _planning_gate_model(self) -> Optional[_ConditionalProbabilities]:
        """``solve_suborder`` rebuilds precedence-only constraints, so the
        conditional constraints' Eq.-8 probabilities are folded into the
        re-solve's cost matrix instead."""
        if self.constraints is None or not self.constraints.conditional:
            return None
        return _ConditionalProbabilities(self.constraints)

    def _resolve_matrix(self) -> np.ndarray:
        """Switching-cost matrix for per-plan re-solving (expected costs
        under conditional constraints, the exact matrix otherwise)."""
        if self._resolve_mat is None:
            gm = self._planning_gate_model()
            self._resolve_mat = (
                self.cost_model.expected_cost_matrix(gm)
                if gm is not None else self._cost_matrix
            )
        return self._resolve_mat

    def plan_groups(
        self, requests: Sequence[MultitaskRequest]
    ) -> List[RequestGroup]:
        """The group plan :meth:`serve_batch` runs for ``requests``.

        Deterministic, so callers can plan, predict (via
        :meth:`predicted_group_stats`), and then serve the same requests.
        With ``policy.resolve_order_per_plan`` on, each group's internal
        task order is re-solved here and recorded on ``RequestGroup.order``.
        """
        use_order = self.group_ordering
        groups = self.scheduler.plan(
            requests,
            num_tasks=self.program.graph.num_tasks,
            cost_model=self.cost_model if use_order else None,
            task_order=self.order if use_order else None,
            initial_resident=(
                self.executor.residency_state()
                if use_order and self.warm_start else None
            ),
        )
        if self.policy.resolve_order_per_plan and all(
            t in self.gate_deps for t in self.gates
        ):
            groups = self._resolve_plan_orders(groups)
        return groups

    def group_order(self, group: RequestGroup) -> Tuple[int, ...]:
        """The task sequence ``group`` executes: its re-solved per-plan
        order when one was recorded, else the global order filtered to the
        group's subset."""
        if group.order is not None:
            return tuple(group.order)
        return tuple(effective_order(self.order, group.tasks))

    def _resolve_plan_orders(
        self, groups: Sequence[RequestGroup]
    ) -> List[RequestGroup]:
        """Residency-aware per-plan task-order re-solving: walking the
        planned groups in execution sequence, each group's subset is
        re-solved over the switching-cost matrix with a virtual start node
        whose edges are the residency-conditioned entry loads, then the
        simulated residency advances past that group."""
        depth = self.program.graph.depth
        resident = (
            self.executor.residency_state() if self.warm_start
            else (None,) * depth
        )
        matrix = self._resolve_matrix()
        gm = self._planning_gate_model()
        out: List[RequestGroup] = []
        for group in groups:
            eff = effective_order(self.order, group.tasks)
            if len(eff) > 1:
                start = [
                    self.cost_model.expected_resume_load_cost(
                        resident, t, gate_model=gm
                    )
                    for t in eff
                ]
                solved = solve_suborder(
                    matrix, eff,
                    start_costs=start, constraints=self._plan_constraints,
                )
                group = dataclasses.replace(group, order=tuple(solved))
            out.append(group)
            if self.warm_start:
                resident = self.cost_model.residency_after(
                    self.group_order(group), resident
                )
        return out

    def predicted_group_stats(
        self, groups: Sequence[RequestGroup]
    ) -> ExecutionStats:
        """Cumulative counter prediction for serving ``groups`` in sequence.

        Warm engines carry residency group-to-group (seeded from the
        executor's *current* residency), cold engines re-predict each group
        from scratch; tasks outside a group's subset count as skipped.
        Assumes every gate fires; with no gates the executor's cumulative
        counters match this exactly.
        """
        predictor = self.cost_model.plan_predictor(
            resume=(
                self.executor.residency_state() if self.warm_start else None
            ),
            carry_residency=self.warm_start,
        )
        for g in groups:
            eff = self.group_order(g)
            predictor.append(
                eff, batch_size=g.valid,
                extra_tasks_skipped=(len(self.order) - len(eff)) * g.valid,
            )
        return predictor.stats

    # ------------------------------------------------------------ execution
    def _inject(self, site: str, **context: Any) -> None:
        """Fault-injection hook: delegates to :attr:`fault_injector` when
        armed; a no-op otherwise.  Sites sit at boundaries where an injected
        exception is indistinguishable from a real one to the session's
        rollback/retry machinery."""
        if self.fault_injector is not None:
            self.fault_injector.check(site, **context)

    def _run_group(
        self, group: RequestGroup, eff: Sequence[int]
    ) -> Tuple[List[Dict[int, torch.Tensor]], ExecutionStats,
               List[TaskGateRecord]]:
        """Execute one homogeneous request group through the batched path.

        Gates are evaluated per request row against that row's outputs so
        far.  A task runs (batched, once) when any row's gate fires; rows
        whose gate did not fire drop the task's output — exact, because a
        task's output depends only on its input row.  Flop/task counters are
        weighted by the fired-row count.  The third return value is the
        group's realized gate trace, one record per task of ``eff``.
        """
        ex = self.executor
        v = group.valid
        per_request: List[Dict[int, torch.Tensor]] = [dict() for _ in range(v)]
        stats = ExecutionStats()
        stats.tasks_skipped += (len(self.order) - len(eff)) * v
        trace: List[TaskGateRecord] = []
        for t in eff:
            g = self.gates.get(t)
            fire = [True] * v if g is None else [bool(g(per_request[i])) for i in range(v)]
            fired = sum(fire)
            stats.tasks_skipped += v - fired
            if fired == 0:
                trace.append(TaskGateRecord(task=t, weight=0, offered=v))
                continue
            self._inject("dispatch", task=t, group_tasks=group.tasks)
            out = ex.run_task_batch(t, group.xs, stats, weight=fired)
            trace.append(dataclasses.replace(ex.last_gate_record, offered=v))
            for i in range(v):
                if fire[i]:
                    per_request[i][t] = out[i]
        return per_request, stats, trace

    def _execute_group(self, group: RequestGroup) -> GroupExecution:
        """Run one planned group; the session's execution primitive.

        Handles the warm/cold group boundary (keep residency and drop
        activations, or full reset), moves the group's inputs to the
        program's device, executes, and predicts the group's counters from
        the executor's residency right before execution (read after the
        ``"plan"`` fault site and the boundary, so a retried attempt
        predicts from the rolled-back residency), conditioned on the
        realized gate trace.
        """
        self._inject("plan", group_tasks=group.tasks, valid=group.valid)
        if self.warm_start:
            self.executor.clear_activations()
        else:
            self.executor.reset()  # cold per group (reference semantics)
        group = dataclasses.replace(group, xs=group.xs.to(self.device))
        eff = self.group_order(group)
        resume = self.executor.residency_state() if self.warm_start else None
        self._inject("load", group_tasks=group.tasks, resume=resume)
        per_request, stats, trace = self._run_group(group, eff)
        predicted = self.cost_model.predicted_stats(
            eff, batch_size=group.valid, resume=resume, gate_trace=trace,
        )
        warm_saved = 0.0
        if self.warm_start:
            cold_pred = self.cost_model.predicted_stats(
                eff, batch_size=group.valid, gate_trace=trace,
            )
            warm_saved = (
                cold_pred.weight_bytes_loaded - predicted.weight_bytes_loaded
            )
        predicted.tasks_skipped += (len(self.order) - len(eff)) * group.valid
        return GroupExecution(
            group=group, eff=eff, outputs=per_request, stats=stats,
            predicted=predicted, warm_saved=warm_saved, gate_trace=trace,
        )

    def _group_responses(
        self, execution: GroupExecution
    ) -> List[MultitaskResponse]:
        """Responses for one executed group, in group-slot order."""
        stats = execution.stats
        group = execution.group
        per_req_seconds = stats.seconds(self.hw) / max(group.valid, 1)
        return [
            MultitaskResponse(
                outputs=execution.outputs[slot],
                stats=dataclasses.replace(stats),
                order=self.order,
                predicted_seconds=per_req_seconds,
                group_size=group.valid,
                warm_weight_bytes_saved=execution.warm_saved,
                effective_order=execution.eff,
            )
            for slot in range(group.valid)
        ]

    # ---------------------------------------------------- one-shot wrappers
    def _serve_via_session(
        self, requests: Sequence[MultitaskRequest]
    ) -> List[MultitaskResponse]:
        """One-shot session: submit everything, drain, collect in order."""
        session = self.session()
        futures = [session.submit(r) for r in requests]
        session.drain()
        self.last_batch_stats = session.stats
        return [f.result() for f in futures]

    def serve_batch(
        self, requests: Sequence[MultitaskRequest]
    ) -> List[MultitaskResponse]:
        """Serve many requests via grouped batched execution.

        A thin wrapper over a one-shot :meth:`session`: every request is
        submitted, then the session drains under the engine's scheduling
        policy (the default :class:`GreedyBatchPolicy` admits the whole list
        as one planning batch).  The scheduler buckets requests into
        homogeneous padded groups (and, with group ordering on, sequences
        them by warm boundary cost); each group runs the block-cached
        executor once with every block batched over the group, so weight
        loads amortise across its requests.  A warm engine keeps residency
        between groups.  ``last_batch_stats`` holds the session's cumulative
        counters.  Responses come back in submission order; a request whose
        group failed raises its :class:`RequestError` here.
        """
        return self._serve_via_session(requests)

    def serve(self, request: MultitaskRequest) -> MultitaskResponse:
        return self.serve_batch([request])[0]

    def serve_many(
        self, requests: Sequence[MultitaskRequest]
    ) -> List[MultitaskResponse]:
        """Deprecated alias of :meth:`serve_batch`: the same one-shot
        session, with a warning so callers move to ``serve_batch`` or an
        explicit :meth:`session`."""
        warnings.warn(
            "MultitaskEngine.serve_many is deprecated; use serve_batch() or "
            "a ServingSession (engine.session()) instead",
            DeprecationWarning,
            stacklevel=2,
        )
        return self._serve_via_session(list(requests))


# --------------------------------------------------------------------------
# LM serving
# --------------------------------------------------------------------------

class LMServer:
    """Batched prefill + greedy decode for any architecture of the zoo.

    Runs on the device of ``params``.  On CUDA the prefill attends through
    the flash kernel (the enc-dec's encoder and cross-attention included)
    and runs each Mamba2 SSD through the SSD kernel; each decode token
    attends over the KV cache and steps the SSM recurrence.
    """

    def __init__(self, model: ModelApi, params: Any):
        self.model = model
        self.params = params

    def generate(self, prompts: Any, steps: int, features: Any = None) -> np.ndarray:
        """Greedy generation.  prompts: (B, S0) token ids; ``features``
        (B, T_enc, enc_inputs) the enc-dec family's frontend features.
        Returns (B, steps)."""
        _b, s0 = prompts.shape
        total = s0 + steps
        batch = self.model.make_batch(prompts, features)
        logits, cache = self.model.prefill(self.params, batch)
        # Grow the prefill cache to full capacity (KV families only).
        cache = _grow_cache(self.model, cache, total, s0)
        out = []
        tok = torch.argmax(logits, dim=-1)
        cache_len = s0
        for _ in range(steps):
            out.append(tok.cpu().numpy().astype(np.int32))
            logits, cache = self.model.decode_step(self.params, tok, cache, cache_len)
            tok = torch.argmax(logits, dim=-1)
            cache_len += 1
        return np.stack(out, axis=1)


def _grow_kv(kv: KVCache, total: int) -> KVCache:
    """Pad a KV cache's T axis out to ``total`` slots (zeros)."""
    t = kv.k.shape[2]
    if t >= total:
        return kv
    pad = (0, 0, 0, 0, 0, total - t)  # (L, B, T, Hk, Dh): grow T only
    return KVCache(
        k=torch.nn.functional.pad(kv.k, pad), v=torch.nn.functional.pad(kv.v, pad)
    )


def _grow_cache(model: ModelApi, cache: Any, total: int, filled: int) -> Any:
    """Grow a prefill-sized cache to ``total`` positions: a KV cache (or the
    KV part of a hybrid cache, or the self K/V of an enc-dec cache) gets
    zero slots; an SSM cache, a fixed-size summary, and the enc-dec's cross
    K/V stay as they are."""
    if isinstance(cache, KVCache):
        if model.cfg.sliding_window is not None:
            # An SWA ring never needs more than ``window`` slots; prefill's
            # linear layout (positions < window) is already ring-consistent.
            total = min(total, model.cfg.sliding_window)
        return _grow_kv(cache, total)
    if isinstance(cache, SSMCache):
        return cache
    if isinstance(cache, HybridCache):
        return HybridCache(ssm=cache.ssm, kv=_grow_kv(cache.kv, total))
    if isinstance(cache, EncDecCache):
        return EncDecCache(self_kv=_grow_kv(cache.self_kv, total),
                           cross_k=cache.cross_k, cross_v=cache.cross_v)
    raise TypeError(f"unknown cache type {type(cache).__name__}")
