"""Variety-vs-cost tradeoff analysis and graph selection (paper §3.2-3.3).

For a sweep of model-size budgets, pick for each budget the feasible graph
with the lowest variety score; normalise the resulting variety and execution
cost trends to [0, 1]; return the graph at the point where the two trend
lines intersect — the paper's default selection (Fig. 3), which the developer
may override (paper §5.3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.constraints import Constraints
from repro_torch.core.cost_model import GraphCostModel
from repro_torch.core.ordering import optimal_order
from repro_torch.core.task_graph import TaskGraph, enumerate_task_graphs, variety_score
from repro_torch.core.types import BlockCost, HardwareModel


@dataclasses.dataclass(frozen=True)
class GraphCandidate:
    graph: TaskGraph
    variety: float
    exec_cost: float       # cost of the *optimal order* on this graph
    storage_bytes: float
    order: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TradeoffResult:
    candidates: List[GraphCandidate]
    budgets: np.ndarray
    variety_trend: np.ndarray     # normalised, one point per budget
    cost_trend: np.ndarray        # normalised, one point per budget
    selected: GraphCandidate
    selected_budget: float


def evaluate_graphs(
    graphs: Sequence[TaskGraph],
    affinity: np.ndarray,
    block_costs: Sequence[BlockCost],
    hw: Optional[HardwareModel],
    constraints: Optional[Constraints] = None,
    metric: str = "time",
    order_solver: str = "auto",
) -> List[GraphCandidate]:
    """Paper §3.3 Step 3: variety, size and (order-optimal) cost per graph."""
    out = []
    for g in graphs:
        cm = GraphCostModel(g, block_costs, hw, metric)
        res = optimal_order(cm.cost_matrix(), constraints, solver=order_solver)
        out.append(
            GraphCandidate(
                graph=g,
                variety=variety_score(g, affinity),
                exec_cost=cm.order_cost(list(res.order)),
                storage_bytes=cm.storage_bytes(),
                order=res.order,
            )
        )
    return out


def _normalise(x: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(x)), float(np.max(x))
    if hi - lo < 1e-12:
        return np.zeros_like(x)
    return (x - lo) / (hi - lo)


def tradeoff_curve(
    candidates: Sequence[GraphCandidate],
    num_budgets: int = 33,
) -> TradeoffResult:
    """Paper §3.3 Step 4: budget sweep, trend lines, intersection pick.

    For each budget: the lowest-variety feasible graph.  Variety decreases
    with budget while its execution cost increases; the selected graph sits
    where the normalised trends cross.
    """
    sizes = np.array([c.storage_bytes for c in candidates])
    budgets = np.linspace(float(sizes.min()), float(sizes.max()), num_budgets)
    picks: List[GraphCandidate] = []
    for b in budgets:
        feas = [c for c in candidates if c.storage_bytes <= b + 1e-9]
        picks.append(min(feas, key=lambda c: (c.variety, c.exec_cost)))
    variety = _normalise(np.array([p.variety for p in picks]))
    cost = _normalise(np.array([p.exec_cost for p in picks]))
    # Intersection of the two normalised trend lines: first budget index
    # where the (decreasing) variety trend falls below the (increasing) cost
    # trend; tie-break on the smallest |gap|.
    gap = variety - cost
    cross = int(np.argmin(np.abs(gap)))
    for k in range(len(budgets) - 1):
        if gap[k] >= 0.0 >= gap[k + 1]:
            cross = k + 1 if abs(gap[k + 1]) <= abs(gap[k]) else k
            break
    return TradeoffResult(
        candidates=list(candidates),
        budgets=budgets,
        variety_trend=variety,
        cost_trend=cost,
        selected=picks[cross],
        selected_budget=float(budgets[cross]),
    )


def select_task_graph(
    num_tasks: int,
    num_branch_points: int,
    affinity: np.ndarray,
    block_costs: Sequence[BlockCost],
    hw: Optional[HardwareModel] = None,
    constraints: Optional[Constraints] = None,
    metric: str = "time",
    beam: Optional[int] = None,
    order_solver: str = "auto",
) -> TradeoffResult:
    """End-to-end §3.3 pipeline: enumerate -> evaluate -> tradeoff -> select."""
    variety_fn = (lambda g: variety_score(g, affinity)) if beam else None
    graphs = enumerate_task_graphs(
        num_tasks, num_branch_points, beam=beam, variety_fn=variety_fn
    )
    cands = evaluate_graphs(
        graphs, affinity, block_costs, hw, constraints, metric, order_solver
    )
    return tradeoff_curve(cands)
