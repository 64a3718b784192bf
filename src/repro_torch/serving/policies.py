"""The engine-level policy config, the PyTorch port of
``repro.serving.policies.EnginePolicy``.

This slice carries the fields the one-shot greedy ``serve_batch`` reads.
The session's admission policies (``GreedyBatchPolicy``, ``WindowPolicy``,
``AffinityPolicy``, ``SloAwarePolicy``), the mesh, streaming and adaptive
fields come with the session slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.batching import RequestGroupScheduler


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
      scheduler: the request-group scheduler (bucketing / padding shapes);
        ``None`` means a default :class:`RequestGroupScheduler`, which the
        engine folds back into its ``policy`` at construction.

    The defaults reproduce the reference engine: warm starts, cost-aware
    group ordering, global task order.
    """

    warm_start: bool = True
    group_ordering: bool = True
    resolve_order_per_plan: bool = False
    scheduler: Optional[RequestGroupScheduler] = None
