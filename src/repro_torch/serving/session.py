"""Session-based serving: async admission over the multitask engine, the
PyTorch port of ``repro.serving.session``.

A :class:`ServingSession` decouples the three phases of serving:

* **admission** — :meth:`ServingSession.submit` enqueues a request at any
  time and returns a lightweight :class:`MultitaskFuture` immediately; an
  :class:`AdmissionQueue` accumulates pending requests under a pluggable
  :class:`~repro_torch.serving.policies.SchedulingPolicy` that decides *when*
  a batch fires and *which* requests ride in it (greedy, windowed,
  residency-affine, or SLO-aware);
* **planning** — each admitted batch goes through the engine's planning
  stack (subset bucketing, padding, cost-aware group ordering, optional
  per-plan order re-solving).  Planning is host work;
* **execution** — groups run through the engine's batched executor; each
  response lands in its future as soon as its group has been dispatched.
  CUDA launches are asynchronous, so the outputs a future holds may still
  be materialising on the card; reading them waits as usual.

``session.stats`` accumulates the executed counters and
``session.predicted`` the cost model's incremental prediction (each group
predicted from the executor's actual residency right before it runs,
conditioned on its realized gate trace), so the two are equal field for
field.  ``session.expected`` is the a-priori prediction; with no adaptive
gating (a later slice) it equals ``session.predicted``.

Reliability (see :mod:`repro_torch.serving.reliability`): the session is the
fault boundary of the serving stack, and its unit of failure is the
*group*, not the pump.

* **Deadlines** — a request with ``MultitaskRequest.deadline`` set is
  expired at the top of every pump once the session clock passes it: its
  future fails with :class:`DeadlineExceeded` and it never reaches planning.
* **Backpressure** — ``max_pending`` bounds the admission queue (and
  ``max_pending_per_tenant`` each tenant's share of it).  An over-limit
  submission is either rejected (its future fails immediately with
  :class:`QueueFull`) or, under ``overload="shed"``, admitted by evicting
  the lowest-priority pending request — strictly lower priority than the
  newcomer, youngest first — whose future fails with ``QueueFull(shed=
  True)`` instead.  Every submitted future reaches a terminal state.
* **Failure isolation + crash-consistent recovery** — before each group
  executes, the executor's residency is snapshotted; if the group raises
  anywhere (prediction, weight load, dispatch, a user gate), the snapshot
  is rolled back (``set_residency``) and the group is retried under the
  session's :class:`~repro_torch.serving.reliability.RetryPolicy`: bounded
  exponential backoff on the primary path, then the ``"unfused"`` rung (the
  group re-run with fused dispatch off).  Each retry re-enters
  ``engine._execute_group``, which re-predicts the group from the *actual*
  post-rollback residency, so ``session.stats == session.predicted`` stays
  exact across any number of rollbacks and retries (only successful
  attempts are merged into either side).  A group that exhausts the ladder
  fails only its own futures, each with a :class:`RequestError` carrying
  the request's ``seq``, task subset, tenant and group id, the original
  traceback chained.  A CUDA error that poisons the context (an illegal
  address, a trapped kernel) fails every later attempt the same way, so it
  fails its group and every group after it: the ladder has no special case
  for it.

* **Weight streaming** — with ``streaming`` on, before each group executes
  the pump prefetches that group's non-resident block params
  (``engine.prefetch_group``) behind the *previous* group's modelled
  compute window; the copies run on a side CUDA stream while the previous
  group's kernels still run.  Only an injected ``"prefetch"`` fault
  (:class:`~repro_torch.serving.reliability.InjectedFault`) degrades a
  group to synchronous loads; any other prefetch error raises.
* **Intermittent power** — a session opened with a ``journal``
  (:class:`~repro_torch.serving.journal.Journal`) writes ahead of every
  state transition: requests at admission, ``group_begin`` before a group
  executes, cost-model-placed mid-suffix activation checkpoints at segment
  boundaries, and an atomic ``group_commit`` (outputs + counters +
  residency) after.  A whole-process power failure
  (:class:`~repro_torch.serving.reliability.PowerFailure`, a
  ``BaseException`` the retry ladder never absorbs) leaves the journal as
  the only truth; :meth:`ServingSession.recover` rebuilds a fresh session
  from it with exactly-once responses: committed groups are never re-run,
  the interrupted group resumes from its last durable checkpoint
  (``use_checkpoints=False`` restarts it from scratch), and everything
  still pending is re-enqueued.  An ``energy`` budget
  (:class:`~repro_torch.serving.reliability.EnergyBudget`) duty-cycles the
  pump: a group only executes once its predicted joules (checkpoint writes
  included) fit the storage capacitor, else the pump sleeps exactly the
  harvest time the deficit needs.

The mesh's ``"single_device"`` rung and the adaptive deadline ladder come
with the slices that port the mesh and adaptive gating.

Driving the loop: callers either poll :meth:`step` on their own cadence,
call :meth:`flush` to force one admit-everything pass, or call :meth:`drain`
to serve until the queue is empty.  ``Future.result()`` drains the session
if its response is not ready.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import (
    TYPE_CHECKING, Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple,
)

import torch

from repro_torch.core.types import ExecutionStats
from repro_torch.serving.reliability import (
    DeadlineExceeded, InjectedFault, QueueFull, RequestError, RetryPolicy,
    TenantStats,
)

if TYPE_CHECKING:
    from repro_torch.serving.batching import RequestGroup
    from repro_torch.serving.engine import (
        GroupExecution, MultitaskEngine, MultitaskRequest, MultitaskResponse,
    )
    from repro_torch.serving.journal import Journal, JournalState
    from repro_torch.serving.policies import SchedulingPolicy
    from repro_torch.serving.reliability import EnergyBudget


class MultitaskFuture:
    """Handle for one submitted request's eventual response.

    ``done()`` is non-blocking; ``result()`` drives the owning session's
    :meth:`~ServingSession.drain` when the response is not yet available, so
    a future can always be resolved synchronously.

    A future is *terminal* when ``done()`` is True: either resolved with a
    response, or failed — rejected/shed by backpressure, expired past its
    deadline, or riding in a group whose recovery ladder ran out.  A failed
    future's ``result()`` re-raises the recorded
    :class:`~repro_torch.serving.reliability.RequestError` (original
    traceback chained); ``error()`` peeks at it without raising.  After
    ``drain()`` every submitted future is terminal.
    """

    __slots__ = ("_session", "seq", "_response", "_error")

    def __init__(self, session: "ServingSession", seq: int):
        self._session = session
        self.seq = seq
        self._response: Optional["MultitaskResponse"] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._response is not None or self._error is not None

    def error(self) -> Optional[BaseException]:
        """The recorded failure, or ``None`` (also when still pending)."""
        return self._error

    def result(self) -> "MultitaskResponse":
        if not self.done():
            self._session.drain()
        if self._error is not None:
            raise self._error
        if self._response is None:  # pragma: no cover - drain() guarantees
            raise RuntimeError(f"request {self.seq} unresolved after drain")
        return self._response

    def _set(self, response: "MultitaskResponse") -> None:
        self._response = response

    def _fail(self, error: BaseException) -> None:
        self._error = error

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = (
            "failed" if self._error is not None
            else "done" if self._response is not None else "pending"
        )
        return f"MultitaskFuture(seq={self.seq}, {state})"


@dataclasses.dataclass
class PendingRequest:
    """One queued request awaiting admission.

    ``subset`` is the request's normalized task subset (the scheduler's
    bucket key), computed once at submit time so admission policies can
    bucket/score pending requests without re-normalizing the queue on every
    pump.
    """

    seq: int
    request: "MultitaskRequest"
    arrival: float
    future: MultitaskFuture
    subset: object = None

    @property
    def deadline(self) -> Optional[float]:
        return self.request.deadline

    @property
    def priority(self) -> int:
        return self.request.priority

    @property
    def tenant(self) -> Optional[str]:
        return self.request.tenant

    def slack(self, now: float) -> float:
        """Seconds until this request's deadline (``inf`` without one)."""
        if self.request.deadline is None:
            return float("inf")
        return self.request.deadline - now


class AdmissionQueue:
    """FIFO of pending requests with policy-directed selective removal.

    Policies read :attr:`pending` (an arrival-ordered snapshot) to score
    candidates, then remove what they admit with :meth:`pop_all`,
    :meth:`pop_first`, or :meth:`pop_seqs` — removal is explicit so a
    request can never be admitted twice or dropped silently.
    """

    def __init__(self) -> None:
        self._entries: List[PendingRequest] = []

    def push(self, entry: PendingRequest) -> None:
        self._entries.append(entry)

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    @property
    def pending(self) -> Tuple[PendingRequest, ...]:
        """Arrival-ordered snapshot of everything awaiting admission."""
        return tuple(self._entries)

    def oldest_arrival(self) -> float:
        if not self._entries:
            raise ValueError("queue is empty")
        return self._entries[0].arrival

    def tenant_count(self, tenant: Optional[str]) -> int:
        """Number of pending entries belonging to ``tenant``."""
        return sum(1 for e in self._entries if e.tenant == tenant)

    def pop_all(self) -> List[PendingRequest]:
        out, self._entries = self._entries, []
        return out

    def pop_first(self, n: int) -> List[PendingRequest]:
        out, self._entries = self._entries[:n], self._entries[n:]
        return out

    def pop_seqs(self, seqs: Iterable[int]) -> List[PendingRequest]:
        """Remove and return the entries with these seqs, arrival-ordered."""
        want = set(seqs)
        out = [e for e in self._entries if e.seq in want]
        missing = want - {e.seq for e in out}
        if missing:
            raise KeyError(f"seqs not pending: {sorted(missing)}")
        self._entries = [e for e in self._entries if e.seq not in want]
        return out


class ServingSession:
    """Async admission + pipelined planning/execution over one engine.

    Args:
      engine: the :class:`MultitaskEngine` to serve through.  A session
        assumes exclusive use of the engine's executor while it has work in
        flight (interleaving one-shot ``serve`` calls shifts residency and
        breaks the incremental prediction's exactness, though never
        correctness).
      policy: the admission :class:`SchedulingPolicy`; defaults to the
        engine's configured ``EnginePolicy.scheduling``.
      clock: time source for arrival stamps, deadlines, and wait/window
        decisions (``time.monotonic`` by default; tests and simulated
        traces inject their own, and every public method also accepts an
        explicit ``now``).
      max_pending: bound on the admission queue (``None`` = unbounded).
        Over-limit submissions are rejected or shed per ``overload``.
      max_pending_per_tenant: per-tenant share of the queue (``None`` =
        no per-tenant quota); enforced the same way, with shedding
        restricted to the offending tenant's own entries.
      overload: ``"reject"`` fails the incoming future with
        :class:`QueueFull`; ``"shed"`` evicts the lowest-priority pending
        entry with priority strictly below the newcomer's (youngest first)
        and admits the newcomer — falling back to reject when no such
        victim exists.
      retry: the group-recovery :class:`RetryPolicy` (rollback + bounded
        backoff + the unfused rung).  ``RetryPolicy(max_retries=0,
        degrade=False)`` fails a group on its first error — still isolated
        to that group, never the whole pump.
      sleep: backoff sleep hook (``time.sleep``); tests and simulated-clock
        runs inject a no-op.  Never called when the policy's backoff base
        is 0.
      streaming: double-buffered weight streaming (defaults to the engine's
        ``EnginePolicy.streaming``): each group's non-resident block params
        are prefetched behind the previous group's modelled compute window.
        The first group of a session (and the group after any failure)
        loads synchronously: there is no window to hide behind.  Requires a
        warm-start engine.
      journal: a write-ahead :class:`~repro_torch.serving.journal.Journal`
        making the session power-failure-atomic (requires a warm-start
        engine: the journal's residency records model weights living in the
        durable tier across power cycles).
      checkpointing: ``False`` keeps the journal's exactly-once semantics
        but never cuts a suffix — the restart-from-scratch arm.
      energy: an :class:`~repro_torch.serving.reliability.EnergyBudget`
        duty-cycling the pump.
    """

    #: recent admission-latency samples kept in ``waits`` (aggregates in
    #: ``wait_sum`` / ``wait_max`` / ``mean_admission_wait`` cover all).
    WAITS_WINDOW = 4096

    def __init__(
        self,
        engine: "MultitaskEngine",
        policy: Optional["SchedulingPolicy"] = None,
        clock: Optional[Callable[[], float]] = None,
        max_pending: Optional[int] = None,
        max_pending_per_tenant: Optional[int] = None,
        overload: str = "reject",
        retry: Optional[RetryPolicy] = None,
        sleep: Optional[Callable[[float], None]] = None,
        streaming: Optional[bool] = None,
        journal: Optional["Journal"] = None,
        checkpointing: bool = True,
        energy: Optional["EnergyBudget"] = None,
    ):
        if overload not in ("reject", "shed"):
            raise ValueError(
                f"overload must be 'reject' or 'shed', got {overload!r}"
            )
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if max_pending_per_tenant is not None and max_pending_per_tenant < 1:
            raise ValueError(
                f"max_pending_per_tenant must be >= 1, "
                f"got {max_pending_per_tenant}"
            )
        self.engine = engine
        self.policy = policy if policy is not None else engine.policy.scheduling
        self._clock = clock if clock is not None else time.monotonic
        self.queue = AdmissionQueue()
        self.max_pending = max_pending
        self.max_pending_per_tenant = max_pending_per_tenant
        self.overload = overload
        self.retry = retry if retry is not None else RetryPolicy()
        self._sleep = sleep if sleep is not None else time.sleep
        self.streaming = (
            engine.policy.streaming if streaming is None else bool(streaming)
        )
        if self.streaming and not engine.warm_start:
            raise ValueError(
                "streaming sessions require a warm-start engine: a cold "
                "reset before every group cancels any staged prefetch"
            )
        if self.streaming:
            engine.executor.streamer.prepare()
        self.journal = journal
        self.checkpointing = bool(checkpointing)
        self.energy = energy
        if journal is not None and not engine.warm_start:
            raise ValueError(
                "journaled (intermittent) sessions require a warm-start "
                "engine: the journal's residency records model weights "
                "living in the durable tier across power cycles, which is "
                "exactly what warm_start keeps — a cold engine would "
                "discard the recovered residency before every group"
            )
        # The overlap window the next prefetch may hide behind: the modelled
        # compute seconds of the last successfully executed group (zero at
        # session start and after any group failure — synchronous recovery).
        self._stream_budget = 0.0
        self._seq = 0
        # ------------------------------------------------- running counters
        self.stats = ExecutionStats()       # executed, cumulative
        self.predicted = ExecutionStats()   # realized-trace prediction
        self.expected = ExecutionStats()    # a-priori prediction (= predicted)
        self.requests_submitted = 0
        self.requests_admitted = 0
        self.requests_rejected = 0
        self.requests_shed = 0
        self.requests_expired = 0
        self.requests_failed = 0
        self.admission_rounds = 0
        self.groups_executed = 0
        self.groups_failed = 0
        self.group_retries = 0          # failed attempts that were retried
        self.degraded_runs = 0          # groups served by a ladder rung
        self.plan_failures = 0          # planning batches that failed whole
        self.backoff_seconds = 0.0      # total retry backoff slept
        self.plan_seconds = 0.0
        self.prefetches_issued = 0      # groups whose loads were streamed
        self.prefetch_scheduled_bytes = 0.0
        self.prefetch_failures = 0      # injected prefetch faults (degraded
                                        # to synchronous loads)
        # The last swallowed prefetch fault, kept for diagnosis.
        self.last_prefetch_error: Optional[BaseException] = None
        self.energy_pauses = 0          # groups that waited for harvest
        self.energy_paused_seconds = 0.0
        self._group_seq = 0             # session-unique execution-group ids
        # seq -> future for every request recovered from a journal (filled
        # by ``ServingSession.recover``; empty for ordinary sessions).
        self.recovered: Dict[int, MultitaskFuture] = {}
        # Admission-latency tracking: running aggregates over every admitted
        # request (exact for the session's whole lifetime) plus a bounded
        # window of recent samples — a long-lived session must not grow a
        # per-request list forever.  ``tenants`` keeps the same exact
        # aggregates per tenant label (None = untenanted).
        self.waits: Deque[float] = collections.deque(maxlen=self.WAITS_WINDOW)
        self.wait_sum = 0.0
        self.wait_max = 0.0
        self.tenants: Dict[Optional[str], TenantStats] = {}

    @property
    def mean_admission_wait(self) -> float:
        """Mean admission latency over every request ever admitted."""
        if not self.requests_admitted:
            return 0.0
        return self.wait_sum / self.requests_admitted

    @property
    def max_admission_wait(self) -> float:
        """Max admission latency over every request ever admitted."""
        return self.wait_max

    def tenant_stats(self, tenant: Optional[str]) -> TenantStats:
        """This tenant's exact admission aggregates (created on first use)."""
        if tenant not in self.tenants:
            self.tenants[tenant] = TenantStats()
        return self.tenants[tenant]

    def tenant_mean_admission_wait(self, tenant: Optional[str]) -> float:
        """Mean admission latency over ``tenant``'s admitted requests."""
        return self.tenant_stats(tenant).mean_admission_wait

    def tenant_max_admission_wait(self, tenant: Optional[str]) -> float:
        """Max admission latency over ``tenant``'s admitted requests."""
        return self.tenant_stats(tenant).max_admission_wait

    # ------------------------------------------------------------ admission
    def _now(self, now: Optional[float]) -> float:
        return self._clock() if now is None else float(now)

    def submit(
        self, request: "MultitaskRequest", now: Optional[float] = None
    ) -> MultitaskFuture:
        """Enqueue one request; returns its future immediately.

        Nothing executes until a pump (:meth:`step` / :meth:`flush` /
        :meth:`drain`) lets the scheduling policy admit it — that is what
        makes one-shot ``serve_batch`` (submit all, then drain) plan the
        whole list as a single batch.

        ``submit`` never raises for capacity: when the bounded queue (or the
        tenant's quota) is full and shedding finds no lower-priority victim,
        the returned future is already failed with :class:`QueueFull`.
        """
        fut = MultitaskFuture(self, self._seq)
        entry = PendingRequest(
            seq=self._seq, request=request, arrival=self._now(now), future=fut,
            subset=self.engine.normalized_subset(request.tasks),
        )
        self._seq += 1
        self.requests_submitted += 1
        self.tenant_stats(entry.tenant).submitted += 1
        if self._admit_to_queue(entry):
            # Write-ahead: the request is durable the moment it is queued,
            # so a power failure never loses an acknowledged request.
            if self.journal is not None:
                self.journal.admit(
                    entry.seq, request.x, request.tasks,
                    deadline=request.deadline, priority=request.priority,
                    tenant=request.tenant,
                )
            self.queue.push(entry)
        return fut

    def _admit_to_queue(self, entry: PendingRequest) -> bool:
        """Backpressure gate: may shed a victim or fail ``entry``'s future.

        Returns True when ``entry`` should be queued.  Quotas are checked
        innermost-first: the tenant's own share, then the global bound —
        shedding for a tenant-quota breach only ever evicts that tenant's
        entries, so one tenant's burst cannot push out another's work.
        """
        if self.max_pending_per_tenant is not None:
            if self.queue.tenant_count(entry.tenant) >= \
                    self.max_pending_per_tenant:
                if not self._try_shed(entry, tenant_scope=True):
                    self._reject(entry, scope="tenant quota")
                    return False
        if self.max_pending is not None and len(self.queue) >= self.max_pending:
            if not self._try_shed(entry, tenant_scope=False):
                self._reject(entry, scope="queue")
                return False
        return True

    def _try_shed(self, entry: PendingRequest, tenant_scope: bool) -> bool:
        """Evict the weakest strictly-lower-priority pending entry.

        Victim selection: lowest priority first, youngest arrival within a
        priority class.  Only entries with priority *strictly below* the
        newcomer's qualify — shedding equals for a newcomer would let two
        same-priority streams evict each other forever.
        """
        if self.overload != "shed":
            return False
        candidates = [
            e for e in self.queue.pending
            if e.priority < entry.priority
            and (not tenant_scope or e.tenant == entry.tenant)
        ]
        if not candidates:
            return False
        victim = min(candidates, key=lambda e: (e.priority, -e.seq))
        self.queue.pop_seqs([victim.seq])
        self.requests_shed += 1
        self.tenant_stats(victim.tenant).shed += 1
        victim.future._fail(QueueFull(
            f"request {victim.seq} shed for a priority-{entry.priority} "
            f"arrival (own priority {victim.priority})",
            shed=True, seq=victim.seq, tasks=victim.subset,
            tenant=victim.tenant,
        ))
        if self.journal is not None:
            self.journal.request_failed(victim.seq)
        return True

    def _reject(self, entry: PendingRequest, scope: str) -> None:
        self.requests_rejected += 1
        self.tenant_stats(entry.tenant).rejected += 1
        entry.future._fail(QueueFull(
            f"request {entry.seq} rejected: {scope} full "
            f"(max_pending={self.max_pending}, "
            f"max_pending_per_tenant={self.max_pending_per_tenant})",
            seq=entry.seq, tasks=entry.subset, tenant=entry.tenant,
        ))

    # ------------------------------------------------------------- pumping
    def step(self, now: Optional[float] = None) -> List["MultitaskResponse"]:
        """One scheduling pump: admit/plan/execute whatever the policy says
        is ready at ``now``.  Returns the responses resolved by this pump,
        in execution order."""
        return self._pump(self._now(now), flush=False)

    def flush(self, now: Optional[float] = None) -> List["MultitaskResponse"]:
        """Pump with flush semantics: thresholds off, queue emptied."""
        return self._pump(self._now(now), flush=True)

    def drain(self) -> List["MultitaskResponse"]:
        """Serve until nothing is pending.

        Always terminates with every submitted future terminal: responses
        for served requests, typed failures for everything else (expired,
        shed, or in a group whose recovery ladder ran out).  Failures do
        not raise here — they are delivered through the futures.
        """
        out = self.flush()
        if self.queue:
            raise RuntimeError(
                f"drain incomplete: scheduling policy {self.policy!r} "
                f"returned no admissions on flush with "
                f"{len(self.queue)} request(s) still pending — flush=True "
                f"must empty the queue (see SchedulingPolicy.admit)"
            )
        return out

    def pending_count(self) -> int:
        return len(self.queue)

    def _expire_deadlines(self, now: float) -> None:
        """Fail every pending request whose deadline has passed.

        Runs at the top of each pump, before the policy sees the queue, so
        an overdue request is never planned, never pads a group, and never
        counts toward admission-wait aggregates.
        """
        expired = [
            e for e in self.queue.pending
            if e.deadline is not None and e.deadline <= now
        ]
        if not expired:
            return
        self.queue.pop_seqs(e.seq for e in expired)
        for e in expired:
            self.requests_expired += 1
            self.tenant_stats(e.tenant).expired += 1
            e.future._fail(DeadlineExceeded(
                f"request {e.seq} missed its deadline "
                f"({e.request.deadline:.6g}) at t={now:.6g} before planning",
                seq=e.seq, tasks=e.subset, tenant=e.tenant,
            ))
            if self.journal is not None:
                self.journal.request_failed(e.seq)

    def _record_wait(self, entry: PendingRequest, now: float) -> None:
        wait = now - entry.arrival
        self.waits.append(wait)
        self.wait_sum += wait
        self.wait_max = max(self.wait_max, wait)
        tstats = self.tenant_stats(entry.tenant)
        tstats.admitted += 1
        tstats.wait_sum += wait
        tstats.wait_max = max(tstats.wait_max, wait)

    def _pump(self, now: float, flush: bool) -> List["MultitaskResponse"]:
        completed: List["MultitaskResponse"] = []
        self._expire_deadlines(now)
        while True:
            admitted = self.policy.admit(self.queue, self.engine, now, flush)
            if not admitted:
                break
            self.admission_rounds += 1
            self.requests_admitted += len(admitted)
            for p in admitted:
                self._record_wait(p, now)
            try:
                t0 = time.perf_counter()
                groups = self.engine.plan_groups(
                    [p.request for p in admitted])
                self.plan_seconds += time.perf_counter() - t0
            except Exception as err:
                # Planning failed before any group existed: the whole
                # admitted batch fails, but only this batch.  The queue, the
                # executor and the counters are untouched (planning mutates
                # none of them), so the session keeps serving.
                self.plan_failures += 1
                self._fail_batch(admitted, err, group_id=None)
                continue
            for group in groups:
                group_id = self._group_seq
                self._group_seq += 1
                members = tuple(admitted[slot] for slot in group.indices)
                if self.journal is not None:
                    # Write-ahead: membership, order and identity of the
                    # group are durable before anything executes, so a crash
                    # inside it leaves an *open* group recovery resumes (or
                    # re-runs) exactly once.
                    self.journal.group_begin(
                        group_id, [p.seq for p in members],
                        self.engine.group_order(group), group.valid,
                    )
                if self.energy is not None and not self._energy_gate(
                        group, members, group_id, now):
                    # Infeasible forever: members failed, pump moves on.
                    self._stream_budget = 0.0
                    continue
                if self.streaming and self._stream_budget > 0.0:
                    # The previous group's kernels may still run on the card;
                    # stream this group's non-resident weights behind them.
                    self._prefetch(group)
                execution, retries, degraded = self._run_group_guarded(
                    group, members, group_id)
                if execution is None:
                    # Ladder exhausted; members already failed.  No window
                    # survives a failed group.
                    self._stream_budget = 0.0
                    continue
                self.groups_executed += 1
                if self.streaming:
                    self._stream_budget = execution.predicted.compute_seconds(
                        self.engine.hw
                    )
                if self.energy is not None:
                    # Spend what the group actually cost (clamped at the
                    # reservation so rounding at the boundary is benign).
                    spent = execution.stats.energy(self.engine.hw)
                    self.energy.drain(min(spent, self.energy.available))
                self.stats = self.stats.merge(execution.stats)
                self.predicted = self.predicted.merge(execution.predicted)
                self.expected = self.expected.merge(execution.predicted)
                if self.journal is not None:
                    # Atomic commit: outputs + counters + the residency the
                    # group leaves behind, in one durable record.  Futures
                    # resolve only after this point, so a delivered response
                    # is always a journaled response — exactly-once.
                    self.journal.group_commit(
                        group_id, [p.seq for p in members],
                        execution.outputs,
                        self.engine.executor.residency_state(),
                        execution.stats,
                    )
                # Resolve immediately: building responses is host work over
                # counters, and a failure in a later group must not strand
                # futures whose group already ran.
                completed.extend(self._resolve(
                    execution, members, retries=retries, degraded=degraded))
        return completed

    # --------------------------------------------------- energy budgeting
    def _group_required_joules(self, group: "RequestGroup") -> float:
        """The joules executing ``group`` from the executor's *current*
        residency will cost (checkpoint writes included) — the reservation
        the energy gate holds against the storage capacitor."""
        engine = self.engine
        eff = engine.group_order(group)
        resume = (
            engine.executor.residency_state() if engine.warm_start else None
        )
        plan = None
        if self.journal is not None and self.checkpointing:
            plan = engine.cost_model.plan_checkpoints(
                eff, batch_size=group.valid
            )
        pred = engine.cost_model.predicted_stats(
            eff, batch_size=group.valid, resume=resume, checkpoints=plan
        )
        return pred.energy(engine.hw)

    def _energy_gate(
        self,
        group: "RequestGroup",
        members: Tuple[PendingRequest, ...],
        group_id: int,
        now: float,
    ) -> bool:
        """Duty-cycle the pump: wait for harvest until ``group`` fits.

        Returns True when the group may execute.  A group whose predicted
        joules exceed the storage capacity outright fails its members —
        isolated to the group, like an exhausted retry ladder — and False
        comes back.  Otherwise the pump sleeps precisely the deficit's
        harvest time and credits precisely that harvest, so paused
        executions are deterministic under real and simulated clocks.
        """
        budget = self.energy
        budget.harvest(now)
        need = self._group_required_joules(group)
        wait = budget.seconds_until(need)
        if wait == float("inf"):
            self.groups_failed += 1
            self._fail_batch(members, RuntimeError(
                f"group {group_id} needs {need:.6g} J but the energy "
                f"budget can never supply it (capacity "
                f"{budget.capacity_joules:.6g} J, harvest "
                f"{budget.harvest_watts:.6g} W)"
            ), group_id=group_id)
            return False
        if wait > 0.0:
            self.energy_pauses += 1
            self.energy_paused_seconds += wait
            self._sleep(wait)
            budget.advance(wait)
        return True

    # ------------------------------------------------- weight streaming
    def _prefetch(self, group: "RequestGroup") -> None:
        """Stage ``group``'s weight stream behind the current overlap window.

        Consumes the window either way (one compute window hides one
        group's loads).  An injected ``"prefetch"`` fault is not fatal: the
        streamer is cancelled and the group loads synchronously, counters
        exact for the schedule it actually ran.  Any other error — a failed
        copy, no CUDA stream — propagates.
        """
        budget = self._stream_budget
        self._stream_budget = 0.0
        try:
            scheduled = self.engine.prefetch_group(
                group, overlap_seconds=budget
            )
        except InjectedFault as err:
            self.prefetch_failures += 1
            self.last_prefetch_error = err
            self.engine.executor.streamer.cancel()
            return
        if scheduled > 0.0:
            self.prefetches_issued += 1
            self.prefetch_scheduled_bytes += scheduled

    # ------------------------------------------------- failure recovery
    def _run_group_guarded(
        self,
        group: "RequestGroup",
        members: Tuple[PendingRequest, ...],
        group_id: int,
    ) -> Tuple[Optional["GroupExecution"], int, Optional[str]]:
        """Execute one group with rollback, bounded retries, and the
        ``"unfused"`` rung.  Returns ``(execution, failed_attempts,
        degraded_rung)``; ``execution`` is ``None`` when every rung failed
        (the members' futures are failed before returning)."""
        retry = self.retry
        failures = 0
        last_err: Optional[BaseException] = None
        for attempt in range(1 + retry.max_retries):
            if attempt > 0:
                self.group_retries += 1
                pause = retry.backoff_seconds(attempt - 1)
                if pause > 0.0:
                    self.backoff_seconds += pause
                    self._sleep(pause)
            try:
                return self._attempt_group(group, group_id), failures, None
            except Exception as err:
                failures += 1
                last_err = err
        if retry.degrade and self.engine.executor.fused:
            # Rung: the per-block reference dispatch on the same executor —
            # identical counters, allclose outputs, no fused program in the
            # failure path.
            self.engine.executor.fused = False
            try:
                execution = self._attempt_group(group, group_id)
                self.degraded_runs += 1
                return execution, failures, "unfused"
            except Exception as err:
                failures += 1
                last_err = err
            finally:
                self.engine.executor.fused = True
        self.groups_failed += 1
        self._fail_batch(members, last_err, group_id=group_id)
        return None, failures, None

    def _attempt_group(
        self, group: "RequestGroup", group_id: Optional[int] = None
    ) -> "GroupExecution":
        """One execution attempt with crash-consistent rollback: the
        residency snapshot taken here is restored on *any* exception, so a
        mid-group crash is invisible to the next attempt's prediction.  (A
        :class:`~repro_torch.serving.reliability.PowerFailure` passes
        through the rollback harmlessly: recovery re-seeds the executor
        from the journal.)"""
        intermittent = None
        if self.journal is not None and group_id is not None:
            from repro_torch.serving.engine import IntermittentContext

            intermittent = IntermittentContext(
                journal=self.journal, group_id=group_id,
                checkpointing=self.checkpointing,
            )
        snapshot = self.engine.executor.residency_state()
        try:
            return self.engine._execute_group(group, intermittent=intermittent)
        except BaseException:
            self.engine.executor.set_residency(snapshot)
            raise

    def _fail_batch(
        self,
        entries: Tuple[PendingRequest, ...],
        err: Optional[BaseException],
        group_id: Optional[int],
    ) -> None:
        """Fail every unresolved entry with its own chained RequestError."""
        where = (
            "planning" if group_id is None else f"execution group {group_id}"
        )
        for p in entries:
            if p.future.done():
                continue
            self.requests_failed += 1
            self.tenant_stats(p.tenant).failed += 1
            wrapped = RequestError(
                f"request {p.seq} (tasks={sorted(p.subset) if p.subset else 'all'}) "
                f"failed in {where}: {err!r}",
                seq=p.seq, tasks=p.subset, tenant=p.tenant, group_id=group_id,
            )
            wrapped.__cause__ = err  # chain the original traceback
            p.future._fail(wrapped)
            if self.journal is not None:
                # Durable terminal outcome: recovery must not resurrect a
                # request whose failure was already delivered.
                self.journal.request_failed(p.seq)

    def _resolve(
        self,
        execution: "GroupExecution",
        members: Tuple[PendingRequest, ...],
        retries: int = 0,
        degraded: Optional[str] = None,
    ) -> List["MultitaskResponse"]:
        """Build responses for one executed group and fill its futures."""
        responses = self.engine._group_responses(execution)
        for entry, response in zip(members, responses):
            response.retries = retries
            response.degraded = degraded
            entry.future._set(response)
        return responses

    # ------------------------------------------------ power-failure recovery
    @classmethod
    def recover(
        cls,
        journal: "Journal",
        engine: "MultitaskEngine",
        use_checkpoints: bool = True,
        now: Optional[float] = None,
        **kwargs: Any,
    ) -> "ServingSession":
        """Rebuild a session from a durable journal after a power failure.

        The journal is the only survivor of the crash; everything
        session-shaped is reconstructed from its replay:

        * **committed groups** are never re-run — their members' futures
          come back resolved, rebuilt from the journaled outputs and
          counters (``MultitaskResponse.recovered`` set).  Replay keeps the
          *first* commit per group, so a journal holding a previous
          recovery's duplicate records stays exactly-once.
        * **the interrupted group** (begun, never committed) is resumed at
          once under its original group id: residency is restored from the
          last committed transition, and with ``use_checkpoints`` the
          journaled activation checkpoint seeds the executor, the group's
          order is rotated so the checkpointed task runs first, and its
          suffix resumes from the checkpoint depth, not from block 0.
          ``use_checkpoints=False`` re-runs it cold.
        * **pending requests** (admitted, no durable outcome) are
          re-enqueued under their original seqs with fresh futures.

        Returns the new session; :attr:`recovered` maps every surviving seq
        to its future (drive :meth:`drain` to finish the backlog).  Extra
        keyword arguments forward to the constructor.  May itself die with a
        :class:`~repro_torch.serving.reliability.PowerFailure` if the
        injector strikes during the resumed group — the journal stays
        consistent and a later ``recover`` picks up from the newest
        checkpoint.
        """
        state = journal.replay()
        kwargs.setdefault("checkpointing", use_checkpoints)
        session = cls(engine, journal=journal, **kwargs)
        t0 = session._now(now)
        session._seq = max(state.admitted, default=-1) + 1
        session._group_seq = state.next_group_id
        # The durable residency transition: the last *committed* residency
        # is what the rebooted executor wakes up with.  The scratch arm
        # trusts nothing but the outputs.
        if use_checkpoints and state.residency is not None:
            engine.executor.set_residency(state.residency)
        else:
            engine.executor.reset()
        for seq, rec in state.responses.items():
            fut = MultitaskFuture(session, seq)
            fut._set(session._rebuild_response(rec))
            session.recovered[seq] = fut
        pending = set(state.pending_seqs)
        resumed: set = set()
        if state.inflight is not None:
            resumed = session._resume_inflight(state, use_checkpoints, pending)
        for seq in state.pending_seqs:
            if seq not in resumed:
                session._reenqueue(state.admitted[seq], t0)
        return session

    def _rebuild_response(self, rec: Dict[str, Any]) -> "MultitaskResponse":
        """A committed group's response, rebuilt from its journal record
        (outputs back on the engine's device)."""
        from repro_torch.serving.engine import MultitaskResponse

        stats = dataclasses.replace(rec["stats"])
        group_size = max(int(rec["group_size"]), 1)
        return MultitaskResponse(
            outputs={
                int(t): torch.as_tensor(v).to(self.engine.device)
                for t, v in rec["outputs"].items()
            },
            stats=stats,
            order=self.engine.order,
            predicted_seconds=stats.seconds(self.engine.hw) / group_size,
            group_size=int(rec["group_size"]),
            recovered=True,
        )

    @staticmethod
    def _request_of(admit_rec: Dict[str, Any]) -> "MultitaskRequest":
        from repro_torch.serving.engine import MultitaskRequest

        tasks = admit_rec["tasks"]
        return MultitaskRequest(
            x=admit_rec["x"],
            tasks=None if tasks is None else tuple(int(t) for t in tasks),
            deadline=admit_rec["deadline"],
            priority=int(admit_rec["priority"]),
            tenant=admit_rec["tenant"],
        )

    def _reenqueue(self, admit_rec: Dict[str, Any], now: float) -> MultitaskFuture:
        """Re-enqueue one journaled-but-unserved request under its original
        seq.  Bypasses :meth:`submit` on purpose: the request is already
        durable, and backpressure does not re-apply to work the previous
        incarnation already accepted."""
        seq = int(admit_rec["seq"])
        request = self._request_of(admit_rec)
        fut = MultitaskFuture(self, seq)
        self.queue.push(PendingRequest(
            seq=seq, request=request, arrival=now, future=fut,
            subset=self.engine.normalized_subset(request.tasks),
        ))
        self.requests_submitted += 1
        self.recovered[seq] = fut
        return fut

    def _resume_inflight(
        self,
        state: "JournalState",
        use_checkpoints: bool,
        pending: set,
    ) -> set:
        """Resume (or re-run) the journal's interrupted group right now.

        Reconstructs the group from its members' admit records, restores the
        journaled activation checkpoint when ``use_checkpoints``, and
        executes under the *original* group id so the commit closes the open
        ``group_begin``.  Returns the member seqs it completed; an empty set
        means the group could not be resumed in place (its members re-enter
        the queue and get re-planned).  Rotation is skipped for gated or
        conditionally-constrained engines: gates read outputs-so-far, so a
        prefix-rotated order could change what fires.
        """
        from repro_torch.core.executor import ActivationCheckpoint
        from repro_torch.serving.engine import IntermittentContext

        rec = state.inflight
        gid = int(rec["group_id"])
        member_seqs = [int(s) for s in rec["seqs"]]
        if not member_seqs or any(s not in pending for s in member_seqs):
            return set()
        admits = [state.admitted.get(s) for s in member_seqs]
        if any(a is None for a in admits):
            return set()
        requests = [self._request_of(a) for a in admits]
        groups = self.engine.plan_groups(requests)
        if len(groups) != 1 or groups[0].valid != len(requests):
            return set()  # cannot reconstruct the exact group; replan
        group = groups[0]
        order = tuple(int(t) for t in rec["order"])
        first_task_resume = 0
        if use_checkpoints and state.checkpoint is not None:
            ck = state.checkpoint
            # Rotate by the checkpoint's *task*, never its recorded ``pos``:
            # pos is relative to the order of the boot that wrote it, and a
            # previous recovery may already have rotated that order.
            ck_task = int(ck["task"])
            pos = order.index(ck_task) if ck_task in order else -1
            rotated = order[pos:] + order[:pos]
            rotation_safe = (
                not self.engine.gates
                and (self.engine.constraints is None
                     or self.engine.constraints.is_valid_order(rotated))
            )
            if rotation_safe and 0 <= pos < len(order):
                order = rotated
                first_task_resume = int(ck["depth"]) + 1
                self.engine.executor.restore_activation(ActivationCheckpoint(
                    depth=int(ck["depth"]),
                    node=state.checkpoint_node(),
                    value=ck["value"],
                    act_shape=(
                        tuple(int(s) for s in ck["act_shape"])
                        if ck["act_shape"] is not None else None
                    ),
                ))
        group = dataclasses.replace(group, order=order)
        ctx = IntermittentContext(
            journal=self.journal, group_id=gid,
            checkpointing=self.checkpointing,
        )
        try:
            execution = self.engine._execute_group(
                group, intermittent=ctx,
                first_task_resume=first_task_resume,
                keep_activations=first_task_resume > 0,
            )
        except Exception:
            # Roll back to the journaled state and let ordinary planning
            # re-run the members.  (PowerFailure is a BaseException and
            # deliberately propagates.)
            if use_checkpoints and state.residency is not None:
                self.engine.executor.set_residency(state.residency)
            else:
                self.engine.executor.reset()
            return set()
        self.groups_executed += 1
        self.stats = self.stats.merge(execution.stats)
        self.predicted = self.predicted.merge(execution.predicted)
        self.expected = self.expected.merge(execution.predicted)
        if self.energy is not None:
            spent = execution.stats.energy(self.engine.hw)
            self.energy.drain(min(spent, self.energy.available))
        slot_seqs = [member_seqs[i] for i in group.indices]
        self.journal.group_commit(
            gid, slot_seqs, execution.outputs,
            self.engine.executor.residency_state(), execution.stats,
        )
        responses = self.engine._group_responses(execution)
        for seq, response in zip(slot_seqs, responses):
            fut = MultitaskFuture(self, seq)
            fut._set(response)
            self.recovered[seq] = fut
        return set(member_seqs)
