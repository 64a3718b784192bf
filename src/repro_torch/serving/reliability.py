"""Reliability primitives for fault-tolerant multi-tenant serving, the
PyTorch port of ``repro.serving.reliability`` (framework-free: numpy only).

The session uses these pieces so that a failure stays inside its group:

* **typed per-request errors** — every failed future carries a
  :class:`RequestError` naming the request (``seq``), its task subset, its
  tenant, and (for execution failures) the group it was riding in, with the
  original exception chained as ``__cause__`` so tracebacks survive;
* **deadline / backpressure outcomes** — :class:`DeadlineExceeded` for
  requests that aged past their SLO before planning, :class:`QueueFull` for
  submissions rejected (or pending entries shed) by the session's bounded
  admission queue;
* **:class:`RetryPolicy`** — how a session recovers a failed group: bounded
  exponential backoff on the primary path, then a graceful-degradation
  ladder (re-run the fused dispatch as the unrolled per-block reference, or
  re-run a mesh-sharded group off the mesh) before giving up;
* **:class:`FaultInjector`** — deterministic, seeded fault injection at the
  plan/load/dispatch boundaries of the engine, the hook the chaos checks
  and the property tests drive.  Its generator is numpy's
  ``default_rng(seed)``, as in the reference, so a seed gives the
  reference's fault schedule call for call.

Everything here is host-side control flow: none of it changes what executes
on the device, which is what keeps the engine's counter-exact
``session.stats == session.predicted`` invariant provable *through*
failures — a rolled-back group contributes nothing to either side.

On a mesh every rank runs the same session: the injector decides the same
way on every rank, because its generator is built from the one seed and
every rank consults it at the same sites in the same order — so a fault
fails the same attempt everywhere and the ranks walk the ladder in
lockstep (a fault on one rank alone would hang the others inside a
collective).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Iterable, Mapping, Optional

import numpy as np

__all__ = [
    "RequestError",
    "DeadlineExceeded",
    "QueueFull",
    "InjectedFault",
    "RetryPolicy",
    "FaultInjector",
    "TenantStats",
    "FAULT_SITES",
    "PowerFailure",
    "PowerFailureInjector",
    "POWER_SITES",
    "EnergyBudget",
]


class RequestError(RuntimeError):
    """One request's serving failure, with the request's identity attached.

    Attributes:
      seq: the failed request's session sequence number.
      tasks: its normalized task subset (``None`` = all tasks).
      tenant: its tenant label (``None`` = untenanted).
      group_id: the session-assigned id of the execution group the failure
        happened in, or ``None`` when the request never reached a group
        (planning failures, deadline expiry, queue rejection).

    The causing exception, when there is one, is chained as ``__cause__``
    (original traceback included), so ``future.result()`` re-raising this
    error still shows where the engine actually blew up.
    """

    def __init__(
        self,
        message: str,
        *,
        seq: int,
        tasks: Optional[FrozenSet[int]] = None,
        tenant: Optional[str] = None,
        group_id: Optional[int] = None,
    ):
        super().__init__(message)
        self.seq = seq
        self.tasks = tasks
        self.tenant = tenant
        self.group_id = group_id


class DeadlineExceeded(RequestError):
    """The request aged past its deadline before it could be planned."""


class QueueFull(RequestError):
    """The request was rejected at submit, or shed while pending, because
    the session's bounded queue (global or per-tenant) was over capacity.

    ``shed`` distinguishes the two: ``False`` means this request itself was
    refused admission; ``True`` means it had been queued and was evicted to
    make room for a higher-priority arrival.
    """

    def __init__(self, message: str, *, shed: bool = False, **kwargs: Any):
        super().__init__(message, **kwargs)
        self.shed = shed


class InjectedFault(RuntimeError):
    """A fault deliberately raised by a :class:`FaultInjector`.

    Attributes:
      site: which boundary fired (one of :data:`FAULT_SITES`).
      index: the site's invocation count when it fired (0-based).
      context: the keyword context the engine passed to ``check``.
    """

    def __init__(self, site: str, index: int, context: Dict[str, Any]):
        super().__init__(f"injected fault at {site!r} (invocation {index})")
        self.site = site
        self.index = index
        self.context = dict(context)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a :class:`~repro_torch.serving.session.ServingSession` recovers a group.

    A failed group attempt is always rolled back first (the executor's
    residency snapshot taken before the attempt is restored), so every
    retry re-predicts and re-executes from a consistent state.  Then:

    1. the primary path is retried up to ``max_retries`` times, sleeping
       ``backoff_base * backoff_factor**attempt`` (capped at ``backoff_max``)
       between attempts — classic bounded exponential backoff, aimed at
       transient faults;
    2. with ``degrade=True``, a still-failing group walks the fallback
       ladder: a one-device engine re-runs the group with fused dispatch
       off (the unrolled per-block reference path, identical counters); a
       mesh-sharded engine re-runs the group cold on a lazily built
       off-mesh executor (``"single_device"``, no collective bytes).
       Successful degraded runs are recorded on the response
       (``MultitaskResponse.degraded``);
    3. only when every rung fails do the group's futures fail, each with its
       own :class:`RequestError` — the rest of the session is untouched.

    ``backoff_base=0.0`` (the default) disables sleeping entirely, which is
    what deterministic tests and simulated-clock benchmarks want.
    """

    max_retries: int = 2
    backoff_base: float = 0.0
    backoff_factor: float = 2.0
    backoff_max: float = 1.0
    degrade: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base < 0:
            raise ValueError(
                f"backoff_base must be >= 0, got {self.backoff_base}"
            )

    def backoff_seconds(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based retry index)."""
        if self.backoff_base <= 0.0:
            return 0.0
        return min(
            self.backoff_base * self.backoff_factor ** attempt,
            self.backoff_max,
        )


#: The engine boundaries a :class:`FaultInjector` can fire at.
#:
#: * ``"plan"`` — entry of ``MultitaskEngine._execute_group``, before the
#:   group's prediction is computed (planning/prediction boundary);
#: * ``"load"`` — after the warm/cold residency boundary, immediately before
#:   the group starts executing (the weight-load boundary);
#: * ``"dispatch"`` — inside ``MultitaskEngine._run_group``, before each
#:   task's batched dispatch;
#: * ``"prefetch"`` — entry of ``MultitaskEngine.prefetch_group``, before
#:   the next group's weight stream is staged (streaming sessions only; a
#:   fault here degrades that group to synchronous loads, never fails it).
FAULT_SITES = ("plan", "load", "dispatch", "prefetch")


class FaultInjector:
    """Deterministic seeded fault injection at the engine's boundaries.

    Two triggering modes, combinable:

    * ``rates`` — per-site Bernoulli fault probability, drawn from a seeded
      ``numpy`` generator.  Deterministic for a fixed seed and call
      sequence: the chaos benchmark replays the exact same fault schedule
      every run, so its gates cannot flake.
    * ``script`` — per-site sets of invocation indices that *always* fault
      (0-based, counted per site).  This is how tests stage exact scenarios:
      "the first two dispatches fail, then everything works" exercises the
      retry path without probability.

    ``max_faults`` bounds the total injected across all sites (``None`` =
    unbounded); :attr:`invocations` and :attr:`injected` expose per-site
    counts for assertions and benchmark reporting.

    The injector only *raises* (:class:`InjectedFault`) — it never touches
    engine state itself, so a fired fault looks exactly like any other
    mid-group exception to the session's rollback/retry machinery.
    """

    def __init__(
        self,
        rates: Optional[Mapping[str, float]] = None,
        seed: int = 0,
        script: Optional[Mapping[str, Iterable[int]]] = None,
        max_faults: Optional[int] = None,
    ):
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        for site, rate in self.rates.items():
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {FAULT_SITES}"
                )
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], got {rate}")
        self.script = {
            site: frozenset(int(i) for i in idxs)
            for site, idxs in (script or {}).items()
        }
        for site in self.script:
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {FAULT_SITES}"
                )
        self._rng = np.random.default_rng(seed)
        self.max_faults = max_faults
        self.invocations: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self.injected: Dict[str, int] = {s: 0 for s in FAULT_SITES}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def check(self, site: str, **context: Any) -> None:
        """Raise :class:`InjectedFault` if this invocation is scheduled to
        fail; otherwise return.  Called by the engine at each boundary."""
        index = self.invocations[site]
        self.invocations[site] = index + 1
        fire = index in self.script.get(site, frozenset())
        rate = self.rates.get(site, 0.0)
        if not fire and rate > 0.0:
            # Draw even when capped so the schedule beyond the cap is the
            # schedule an uncapped run would have produced.
            fire = bool(self._rng.random() < rate)
        if not fire:
            return
        if (
            self.max_faults is not None
            and self.total_injected >= self.max_faults
        ):
            return
        self.injected[site] += 1
        raise InjectedFault(site, index, context)


@dataclasses.dataclass
class TenantStats:
    """Per-tenant admission aggregates a :class:`ServingSession` maintains.

    The session's global ``waits`` deque hides per-tenant starvation: a
    quota/SLO policy needs to see that tenant B's requests wait 10x tenant
    A's even when the global mean looks healthy.  Aggregates are exact over
    the tenant's whole lifetime (running sum/max, not a window).
    """

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    shed: int = 0
    expired: int = 0
    failed: int = 0
    wait_sum: float = 0.0
    wait_max: float = 0.0

    @property
    def mean_admission_wait(self) -> float:
        """Mean admission latency over this tenant's admitted requests."""
        if not self.admitted:
            return 0.0
        return self.wait_sum / self.admitted

    @property
    def max_admission_wait(self) -> float:
        """Max admission latency over this tenant's admitted requests."""
        return self.wait_max


# --------------------------------------------------------------------------
# Intermittent power (batteryless / energy-harvesting deployments)
# --------------------------------------------------------------------------

#: The boundaries a :class:`PowerFailureInjector` can kill the session at.
#:
#: * ``"group"`` — inside ``MultitaskEngine._run_group``, before a task's
#:   batched dispatch (mid-group, between tasks);
#: * ``"suffix"`` — at a segmented suffix's block-depth commit point, right
#:   after the checkpoint hook journaled the activation (mid-suffix,
#:   between blocks);
#: * ``"prefetch"`` — entry of ``MultitaskEngine.prefetch_group``
#:   (mid-prefetch, with a stream staged but uncommitted).
POWER_SITES = ("group", "suffix", "prefetch")


class PowerFailure(BaseException):
    """The whole session lost power.

    Deliberately **not** an :class:`Exception`: the session's per-group
    rollback/retry/degradation machinery catches ``Exception``, and a power
    failure must never be "recovered" in-process — it kills everything and
    propagates to the harness, which reboots by building a fresh session
    with :meth:`~repro_torch.serving.session.ServingSession.recover` over the
    durable journal.  (``KeyboardInterrupt`` uses the same idiom for the
    same reason.)
    """

    def __init__(self, site: str, index: int, context: Dict[str, Any]):
        super().__init__(f"power failure at {site!r} (invocation {index})")
        self.site = site
        self.index = index
        self.context = dict(context)


class PowerFailureInjector:
    """Deterministic seeded whole-session power-failure injection.

    The intermittent-computing sibling of :class:`FaultInjector`: same two
    triggering modes (per-site Bernoulli ``rates`` from a seeded generator,
    and per-site ``script`` sets of invocation indices that always fire),
    same per-site :attr:`invocations` / :attr:`injected` counters, same
    ``max_failures`` cap — but it raises :class:`PowerFailure` (a
    ``BaseException``), so the session's group-isolation machinery never
    absorbs it.  The injector itself lives *outside* the session (like the
    FRAM journal), so the same instance keeps its schedule across reboots —
    that is what makes "~20 failures over this trace" reproducible.
    """

    def __init__(
        self,
        rates: Optional[Mapping[str, float]] = None,
        seed: int = 0,
        script: Optional[Mapping[str, Iterable[int]]] = None,
        max_failures: Optional[int] = None,
    ):
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        for site, rate in self.rates.items():
            if site not in POWER_SITES:
                raise ValueError(
                    f"unknown power site {site!r}; expected one of {POWER_SITES}"
                )
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], got {rate}")
        self.script = {
            site: frozenset(int(i) for i in idxs)
            for site, idxs in (script or {}).items()
        }
        for site in self.script:
            if site not in POWER_SITES:
                raise ValueError(
                    f"unknown power site {site!r}; expected one of {POWER_SITES}"
                )
        self._rng = np.random.default_rng(seed)
        self.max_failures = max_failures
        self.invocations: Dict[str, int] = {s: 0 for s in POWER_SITES}
        self.injected: Dict[str, int] = {s: 0 for s in POWER_SITES}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def check(self, site: str, **context: Any) -> None:
        """Raise :class:`PowerFailure` if this invocation is scheduled to
        lose power; otherwise return."""
        index = self.invocations[site]
        self.invocations[site] = index + 1
        fire = index in self.script.get(site, frozenset())
        rate = self.rates.get(site, 0.0)
        if not fire and rate > 0.0:
            # Draw even when capped so the schedule beyond the cap matches
            # what an uncapped run would have produced.
            fire = bool(self._rng.random() < rate)
        if not fire:
            return
        if (
            self.max_failures is not None
            and self.total_injected >= self.max_failures
        ):
            return
        self.injected[site] += 1
        raise PowerFailure(site, index, context)


class EnergyBudget:
    """Duty-cycled energy store: a harvester charging a storage capacitor.

    The session treats this as the paper's batteryless power supply: before
    a group executes, its modelled energy (the cost model's prediction
    through ``hw.energy_joules``, checkpoint writes included) must fit in
    :attr:`available` — otherwise the pump *pauses*, sleeping exactly the
    harvest time the deficit needs (``seconds_until``) before draining and
    proceeding.  All host-side bookkeeping on the session's clock; nothing
    here touches device execution.

    Attributes:
      capacity_joules: storage capacitance ceiling (harvest beyond it is
        spilled, as a real capacitor would).
      harvest_watts: harvest rate in J/s while paused or between groups.
      available: joules currently stored.
      drained_joules / harvested_joules / spilled_joules: lifetime totals.
    """

    def __init__(
        self,
        capacity_joules: float,
        harvest_watts: float,
        initial_joules: Optional[float] = None,
    ):
        if capacity_joules <= 0.0:
            raise ValueError(
                f"capacity_joules must be > 0, got {capacity_joules}"
            )
        if harvest_watts < 0.0:
            raise ValueError(
                f"harvest_watts must be >= 0, got {harvest_watts}"
            )
        self.capacity_joules = float(capacity_joules)
        self.harvest_watts = float(harvest_watts)
        self.available = (
            self.capacity_joules if initial_joules is None
            else min(float(initial_joules), self.capacity_joules)
        )
        if self.available < 0.0:
            raise ValueError(f"initial_joules must be >= 0, got {initial_joules}")
        self._last_harvest: Optional[float] = None
        self.drained_joules = 0.0
        self.harvested_joules = 0.0
        self.spilled_joules = 0.0

    def harvest(self, now: float) -> None:
        """Accrue harvest up to ``now`` (session-clock seconds), clamped to
        capacity.  The first call only anchors the clock."""
        if self._last_harvest is not None and now > self._last_harvest:
            gained = (now - self._last_harvest) * self.harvest_watts
            fits = min(gained, self.capacity_joules - self.available)
            self.available += fits
            self.harvested_joules += fits
            self.spilled_joules += gained - fits
        self._last_harvest = max(
            now,
            self._last_harvest if self._last_harvest is not None else now,
        )

    def advance(self, seconds: float) -> None:
        """Accrue exactly ``seconds`` of harvest, moving the anchor with it.

        The session's pause path uses this instead of :meth:`harvest`: it
        sleeps precisely ``seconds_until(need)`` and credits precisely that
        much harvest, so the pause is deterministic regardless of how the
        injected sleep hook relates to the session clock (a real
        ``time.sleep`` and a simulated-clock no-op behave identically).
        The anchor advances too, so a later ``harvest(now)`` on a clock the
        sleep also advanced does not double-count the paused interval.
        """
        if seconds < 0.0:
            raise ValueError(f"cannot advance {seconds} s")
        gained = seconds * self.harvest_watts
        fits = min(gained, self.capacity_joules - self.available)
        self.available += fits
        self.harvested_joules += fits
        self.spilled_joules += gained - fits
        if self._last_harvest is not None:
            self._last_harvest += seconds

    def can_spend(self, joules: float) -> bool:
        return joules <= self.available

    def seconds_until(self, joules: float) -> float:
        """Harvest seconds until ``joules`` are available (0 if they are).

        ``inf`` when the deficit can never be harvested — the caller should
        fail loudly rather than sleep forever.
        """
        deficit = joules - self.available
        if deficit <= 0.0:
            return 0.0
        if joules > self.capacity_joules or self.harvest_watts <= 0.0:
            return float("inf")
        return deficit / self.harvest_watts

    def drain(self, joules: float) -> None:
        """Spend ``joules``; callers must have checked :meth:`can_spend`."""
        if joules < 0.0:
            raise ValueError(f"cannot drain {joules} J")
        if joules > self.available + 1e-12:
            raise ValueError(
                f"drain of {joules:.6g} J exceeds available "
                f"{self.available:.6g} J — pause and harvest first"
            )
        self.available = max(self.available - joules, 0.0)
        self.drained_joules += joules
