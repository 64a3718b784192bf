"""Gate-probability model: the expected-cost side of input-adaptive serving
(a framework-free copy of ``repro.adaptive.gate_model``, kept equal to it).

A :class:`GateModel` gives the cost model two probability surfaces:

* ``fire_probability(task, depth)`` — of the rows a task runs for, the
  fraction expected to fire its depth-``depth`` block (adaptive confidence
  gating; 1.0 where unknown).
* ``task_probability(task)`` — the fraction of offered rows the task runs
  for at all (legacy whole-group ``gate=`` callbacks, or the conditional
  execution probabilities of Eq. 8's constraints).

``GraphCostModel.expected_stats`` weights FLOP/task counters by these, so
``solve_suborder`` / ``optimal_order`` minimize *expected* bytes/FLOPs when
fed ``expected_cost_matrix``.  Because per-row gate decisions are a
deterministic function of the row (pure confidence on deterministic
activations), the fire fractions are invariant to how rows are grouped or
where suffixes resume — which is why expected predictions converge to
measured means regardless of schedule.

A :class:`GateModelCalibrator` estimates both surfaces from realized
:class:`~repro_torch.core.types.TaskGateRecord` traces — a profiling set offline,
or live serving traffic when ``AdaptivePolicy.calibrate_online`` is set.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.types import TaskGateRecord


@dataclasses.dataclass(frozen=True)
class GateModel:
    """Per-block fire probabilities and per-task execution probabilities.

    Missing entries default to 1.0 (always fires / always runs), so the
    empty model is exactly the all-blocks floor and partial calibration
    degrades gracefully toward it.
    """

    fire: Dict[Tuple[int, int], float] = dataclasses.field(default_factory=dict)
    task_fire: Dict[int, float] = dataclasses.field(default_factory=dict)

    def fire_probability(self, task: int, depth: int) -> float:
        return float(self.fire.get((task, depth), 1.0))

    def task_probability(self, task: int) -> float:
        return float(self.task_fire.get(task, 1.0))

    @classmethod
    def from_constraints(cls, constraints) -> "GateModel":
        """Task probabilities from conditional constraints (Eq. 8).

        Folds each task's conditional in-edge probabilities into
        ``task_fire`` so the expected cost matrix weights its suffix the
        way ``fitness`` weights it — letting ``solve_suborder`` (which
        rebuilds precedence-only constraints and would otherwise drop the
        probabilities) optimize the probability-weighted objective.
        """
        task_fire: Dict[int, float] = {}
        for t in range(constraints.num_tasks):
            p = constraints.execution_probability(t)
            if p != 1.0:
                task_fire[t] = float(p)
        return cls(task_fire=task_fire)


class GateModelCalibrator:
    """Running fire-fraction estimator over realized gate traces.

    ``observe`` folds one group's trace (the executor's per-task
    :class:`TaskGateRecord` list); ``model`` snapshots the current
    estimates.  Per-(task, depth) fire fractions are
    ``rows_fired / rows_offered_to_that_block``; per-task probabilities are
    ``rows_run / rows_offered``.  Depths a trace never executed (shared
    prefixes) contribute nothing — the activation-resume bookkeeping means
    those blocks' fire behaviour is observed whenever some task does
    execute them, and the fractions are grouping-invariant (see module
    docstring), so partial observation is unbiased.
    """

    def __init__(self) -> None:
        self._fired: Dict[Tuple[int, int], float] = {}
        self._live: Dict[Tuple[int, int], float] = {}
        self._ran: Dict[int, float] = {}
        self._offered: Dict[int, float] = {}

    def observe(self, trace) -> None:
        for rec in trace:
            offered = rec.offered if rec.offered is not None else rec.weight
            self._offered[rec.task] = self._offered.get(rec.task, 0.0) + offered
            self._ran[rec.task] = self._ran.get(rec.task, 0.0) + rec.weight
            if rec.fired is None or rec.weight == 0:
                continue
            resume = rec.resume if rec.resume is not None else 0
            for i, fired in enumerate(rec.fired):
                key = (rec.task, resume + i)
                self._live[key] = self._live.get(key, 0.0) + rec.weight
                self._fired[key] = self._fired.get(key, 0.0) + fired

    def model(self) -> GateModel:
        fire = {
            key: self._fired.get(key, 0.0) / live
            for key, live in self._live.items()
            if live > 0
        }
        task_fire = {
            t: self._ran.get(t, 0.0) / offered
            for t, offered in self._offered.items()
            if offered > 0 and self._ran.get(t, 0.0) != offered
        }
        return GateModel(fire=fire, task_fire=task_fire)
