"""Pluggable scheduling policies and the engine-level policy config, the
PyTorch port of ``repro.serving.policies``.

A :class:`SchedulingPolicy` decides *which requests run together, and when*
for a :class:`~repro_torch.serving.session.ServingSession`: each pump of the
session it inspects the admission queue (and, through the engine, the cost
model and the executor's current weight residency) and returns the pending
requests to admit as the next planning batch — or nothing, to keep
accumulating.

Four policies ship:

* :class:`GreedyBatchPolicy` — admit everything pending at once: one plan
  over the whole request list, the policy the one-shot wrappers use.
* :class:`WindowPolicy` — admit by max-wait / max-group-size, in arrival
  order.
* :class:`AffinityPolicy` — residency-aware admission: among the pending
  task-subset buckets, admit the one whose cheapest entry task costs the
  least to resume from the executor's *current* residency.
* :class:`SloAwarePolicy` — affinity admission with SLO overrides: a
  request whose deadline slack has run out (or a tenant starving behind a
  residency-friendly stream) pre-empts the cheapest-resume choice, and
  oversubscribed buckets admit priority-first.

:class:`EnginePolicy` folds everything schedule-shaped about the engine into
one config object, weight streaming included.  The reference's ``mesh``,
``sharding`` and ``adaptive`` fields come with the slices that port those
subsystems.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Protocol

from repro_torch.serving.batching import RequestGroupScheduler, effective_order

if TYPE_CHECKING:  # session/engine import this module; keep runtime acyclic
    from repro_torch.serving.engine import MultitaskEngine
    from repro_torch.serving.session import AdmissionQueue, PendingRequest


class SchedulingPolicy(Protocol):
    """Admission control for a :class:`~repro_torch.serving.session.ServingSession`.

    ``admit`` is called repeatedly during each session pump until it returns
    an empty list: inspect ``queue`` (arrival times, task subsets) and
    ``engine`` (cost model, current residency), pop the entries to admit as
    one planning batch via the queue's ``pop_*`` methods, and return them.
    ``now`` is the session clock reading for this pump.  ``flush=True``
    means the caller intends to empty the queue (``drain()`` or a one-shot
    serve): size/wait thresholds must be ignored, but *selection order*
    is still the policy's to choose — an affinity policy still empties the
    queue residency-nearest-first.
    """

    def admit(
        self,
        queue: "AdmissionQueue",
        engine: "MultitaskEngine",
        now: float,
        flush: bool,
    ) -> List["PendingRequest"]:
        ...


@dataclasses.dataclass(frozen=True)
class GreedyBatchPolicy:
    """Admit everything pending immediately (classic ``serve_batch``).

    One admission round covers the whole queue, so the downstream planner
    sees the full request list at once — exactly what the one-shot entry
    points did before sessions existed, which is why the ``serve`` /
    ``serve_batch`` wrappers run under this policy by default.
    """

    def admit(self, queue, engine, now, flush):
        return queue.pop_all()


@dataclasses.dataclass(frozen=True)
class WindowPolicy:
    """Admit by max-wait / max-group-size, in arrival order.

    Requests accumulate until either ``max_group_size`` are pending (admit
    the first ``max_group_size``) or the oldest pending request has waited
    ``max_wait`` seconds (admit what's there, bounded by the same size cap
    so a long-idle queue still produces bounded groups).  This is the
    arrival-order baseline the residency-aware policies are measured
    against.
    """

    max_wait: float = 0.05
    max_group_size: int = 16

    def __post_init__(self):
        if self.max_group_size < 1:
            raise ValueError(f"max_group_size must be >= 1, got {self.max_group_size}")
        if self.max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {self.max_wait}")

    def admit(self, queue, engine, now, flush):
        if not queue:
            return []
        full = len(queue) >= self.max_group_size
        aged = now - queue.oldest_arrival() >= self.max_wait
        if flush or full or aged:
            return queue.pop_first(self.max_group_size)
        return []


@dataclasses.dataclass(frozen=True)
class AffinityPolicy:
    """Residency-aware admission: group requests whose task subsets share
    deep prefixes with what is already resident.

    Pending requests are bucketed by (normalised) requested task subset.
    When an admission fires, the policy scores every bucket by the cheapest
    ``resume_load_cost`` from the executor's *current* residency to any task
    in the bucket's subset — i.e. how little it would cost to start serving
    that bucket right now, given the blocks the previous group left in
    memory — and admits up to ``max_group_size`` requests (FIFO within the
    bucket) from the best one.  Repeated admission rounds therefore empty
    the queue in a residency-chained sequence, the admission-time analogue
    of ``order_groups``'s boundary-cost TSP, without ever waiting for the
    full request list.

    Thresholds mirror :class:`WindowPolicy`: admissions fire when
    ``min_pending`` (default ``max_group_size``) requests are queued, when
    the oldest has waited ``max_wait`` (``None`` = no ageing trigger), or on
    flush.
    """

    max_group_size: int = 16
    min_pending: Optional[int] = None
    max_wait: Optional[float] = None

    def __post_init__(self):
        if self.max_group_size < 1:
            raise ValueError(f"max_group_size must be >= 1, got {self.max_group_size}")

    def admit(self, queue, engine, now, flush):
        if not queue:
            return []
        aged = (
            self.max_wait is not None
            and now - queue.oldest_arrival() >= self.max_wait
        )
        threshold = (
            self.min_pending if self.min_pending is not None
            else self.max_group_size
        )
        if not (flush or aged or len(queue) >= threshold):
            return []
        buckets: Dict[object, List["PendingRequest"]] = {}
        for p in queue.pending:
            # Normalized once at submit time; pumping stays O(pending).
            buckets.setdefault(p.subset, []).append(p)
        resident = engine.executor.residency_state()

        def resume_cost(subset) -> float:
            tasks = effective_order(engine.order, subset)
            if not tasks:  # empty subset executes nothing: free
                return 0.0
            return min(
                engine.cost_model.resume_load_cost(resident, t) for t in tasks
            )

        _key, best = min(
            buckets.items(),
            key=lambda kv: (
                resume_cost(kv[0]),
                kv[1][0].seq,  # deterministic tie-break: oldest bucket
            ),
        )
        return queue.pop_seqs(p.seq for p in best[: self.max_group_size])


@dataclasses.dataclass(frozen=True)
class SloAwarePolicy:
    """Deadline- and tenant-aware admission layered over residency affinity.

    :class:`AffinityPolicy` minimises switching cost but is SLO-blind: a
    bucket whose requests are about to miss their deadlines waits exactly as
    long as one with no deadline at all, and a tenant whose subsets never
    match the resident prefix can starve indefinitely behind a tenant whose
    subsets always do.  This policy keeps affinity as the *default* choice
    and overrides it only when an SLO is actually at risk — trading
    residency affinity against deadline slack, per the roadmap's
    multi-tenant item:

    1. **urgency** — if any pending request's slack (``deadline - now``)
       is at most ``slack_threshold``, admission fires immediately and the
       bucket containing the most urgent request (minimum slack) is chosen,
       regardless of resume cost.  A near-deadline request never waits for
       a cheaper bucket to finish warming.
    2. **anti-starvation** — otherwise, if some tenant's oldest pending
       request has waited at least ``starvation_wait`` seconds, the bucket
       holding the longest-waiting such request is chosen.  One tenant's
       residency-friendly stream cannot lock out another's forever.
    3. **affinity** — otherwise the bucket with the cheapest
       ``resume_load_cost`` from the executor's current residency wins,
       exactly as :class:`AffinityPolicy` scores it.

    Within the chosen bucket, admission is priority-descending (then
    arrival order), up to ``max_group_size`` — so when a bucket is
    oversubscribed, high-priority requests ride the earlier group.

    Firing thresholds mirror :class:`AffinityPolicy` (``min_pending`` /
    ``max_wait`` / flush), with the urgency rule as an additional trigger:
    a pump that finds an at-risk request admits even below the thresholds.
    """

    max_group_size: int = 16
    min_pending: Optional[int] = None
    max_wait: Optional[float] = None
    slack_threshold: float = 0.0
    starvation_wait: Optional[float] = None

    def __post_init__(self):
        if self.max_group_size < 1:
            raise ValueError(f"max_group_size must be >= 1, got {self.max_group_size}")
        if self.slack_threshold < 0:
            raise ValueError(
                f"slack_threshold must be >= 0, got {self.slack_threshold}"
            )
        if self.starvation_wait is not None and self.starvation_wait < 0:
            raise ValueError(
                f"starvation_wait must be >= 0, got {self.starvation_wait}"
            )

    def admit(self, queue, engine, now, flush):
        if not queue:
            return []
        pending = queue.pending
        urgent = [
            p for p in pending if p.slack(now) <= self.slack_threshold
        ]
        aged = (
            self.max_wait is not None
            and now - queue.oldest_arrival() >= self.max_wait
        )
        threshold = (
            self.min_pending if self.min_pending is not None
            else self.max_group_size
        )
        if not (flush or urgent or aged or len(queue) >= threshold):
            return []
        buckets: Dict[object, List["PendingRequest"]] = {}
        for p in pending:
            buckets.setdefault(p.subset, []).append(p)

        if urgent:
            # Rule 1: serve the most at-risk request's bucket now.
            pick = min(urgent, key=lambda p: (p.slack(now), p.seq))
            chosen = buckets[pick.subset]
        else:
            starving = (
                [
                    p for p in pending
                    if now - p.arrival >= self.starvation_wait
                ]
                if self.starvation_wait is not None else []
            )
            if starving:
                # Rule 2: longest-waiting request breaks the affinity lock.
                pick = min(starving, key=lambda p: (p.arrival, p.seq))
                chosen = buckets[pick.subset]
            else:
                # Rule 3: residency affinity, as AffinityPolicy scores it.
                resident = engine.executor.residency_state()

                def resume_cost(subset) -> float:
                    tasks = effective_order(engine.order, subset)
                    if not tasks:
                        return 0.0
                    return min(
                        engine.cost_model.resume_load_cost(resident, t)
                        for t in tasks
                    )

                _key, chosen = min(
                    buckets.items(),
                    key=lambda kv: (resume_cost(kv[0]), kv[1][0].seq),
                )
        take = sorted(chosen, key=lambda p: (-p.priority, p.seq))
        return queue.pop_seqs(
            p.seq for p in take[: self.max_group_size]
        )


def _default_scheduling() -> SchedulingPolicy:
    return GreedyBatchPolicy()


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Everything schedule-shaped about a :class:`MultitaskEngine`.

    Attributes:
      warm_start: keep executor weight residency across request groups
        (activations are always dropped at group boundaries); ``False``
        resets the executor cold before every group.
      group_ordering: sequence planned groups by the cost model's warm
        boundary costs (``order_groups``) instead of bucket order.
      resolve_order_per_plan: re-solve each planned group's internal task
        order (``ordering.solve_suborder``) seeded with the residency the
        engine will actually have when the group runs.  Runs only when every
        gated task's inputs are declared (``MultitaskEngine(gate_deps=...)``
        or the conditional constraint edges); those inputs become precedence
        edges of the re-solve.
      scheduling: the session admission policy; the one-shot entry points
        (``serve`` / ``serve_batch``) run their internal session under it.
      scheduler: the request-group scheduler (bucketing / padding shapes);
        ``None`` means a default :class:`RequestGroupScheduler`, which the
        engine folds back into its ``policy`` at construction.
      streaming: double-buffered weight streaming: while each group
        executes, the session prefetches the *next* group's non-resident
        block params (``MultitaskEngine.prefetch_group`` ->
        ``WeightStreamer``) on a side CUDA stream, hiding load time behind
        compute.  Prefetched bytes drop out of the modelled synchronous
        load term and any residue appears as
        ``ExecutionStats.stream_stall_seconds``; outputs and byte counters
        are unchanged, and ``session.stats == session.predicted`` stays
        exact.  Requires ``warm_start`` (a cold reset before every group
        would cancel every prefetch).

    The defaults reproduce the reference engine: greedy one-shot admission,
    warm starts, cost-aware group ordering, global task order, synchronous
    loads.
    """

    warm_start: bool = True
    group_ordering: bool = True
    resolve_order_per_plan: bool = False
    scheduling: SchedulingPolicy = dataclasses.field(
        default_factory=_default_scheduling
    )
    scheduler: Optional[RequestGroupScheduler] = None
    streaming: bool = False
