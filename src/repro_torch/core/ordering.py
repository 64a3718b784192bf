"""Optimal task execution order (paper §4).

Three exact solvers plus the fitness functions shared with the GA:

* :func:`brute_force_order` — all ``n!`` permutations, filtered by
  precedence validity (paper §4.4 "Brute-force Solver").
* :func:`held_karp_order` — O(n^2 2^n) exact DP over (visited-set, last)
  states, with precedence pruning; the "optimal" reference for Table 3.
* :class:`ILPFormulation` / :func:`branch_and_bound_order` — the paper's
  integer-linear-programming formulation (Eq. 4 objective, degree
  constraints, subtour elimination, Eq. 6 precedence timing) materialised
  explicitly, solved by depth-first branch-and-bound with an admissible
  min-out-edge bound.  No external ILP solver exists in this environment,
  so B&B plays the exact-solver role; the formulation object is still
  constructed and checked so the Eq. 4-6 structure is tested.

The fitness is the paper's Eq. 7, and Eq. 8 for conditional constraints:
``f(pi) = sum_i  p(pi_{i+1}) * c[pi_i, pi_{i+1}]`` where ``p`` is the
execution probability of the *incoming* task (1 when unconditioned).
The first task's cold cost is a permutation-independent constant under a
common architecture, so ordering by Eq. 7 and ordering by total cost agree;
``include_first_task_cost`` lets callers add it for reporting.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.constraints import Constraints, no_constraints


# --------------------------------------------------------------------------
# Fitness (Eq. 7 / Eq. 8)
# --------------------------------------------------------------------------

def fitness(
    order: Sequence[int],
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
) -> float:
    """Paper Eq. 7 (and Eq. 8 when conditional constraints exist)."""
    total = 0.0
    for a, b in zip(order[:-1], order[1:]):
        p = 1.0
        if constraints is not None and constraints.conditional:
            p = constraints.execution_probability(b)
        total += p * float(cost[a, b])
    return total


@dataclasses.dataclass(frozen=True)
class OrderingResult:
    order: Tuple[int, ...]
    cost: float
    solver: str
    evaluated: int = 0


# --------------------------------------------------------------------------
# Brute force (paper §4.4)
# --------------------------------------------------------------------------

def brute_force_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
) -> OrderingResult:
    n = cost.shape[0]
    cons = constraints or no_constraints(n)
    best: Optional[Tuple[int, ...]] = None
    best_cost = float("inf")
    evaluated = 0
    for perm in itertools.permutations(range(n)):
        if not cons.is_valid_order(perm):
            continue
        evaluated += 1
        f = fitness(perm, cost, cons)
        if f < best_cost:
            best, best_cost = perm, f
    if best is None:
        raise ValueError("no permutation satisfies the precedence constraints")
    return OrderingResult(best, best_cost, "brute_force", evaluated)


# --------------------------------------------------------------------------
# Held-Karp exact DP (path version), with precedence pruning
# --------------------------------------------------------------------------

def held_karp_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
) -> OrderingResult:
    n = cost.shape[0]
    cons = constraints or no_constraints(n)
    # preds[j] = bitmask of tasks that must precede j.
    preds = [0] * n
    for (i, j) in cons.precedence:
        preds[j] |= 1 << i
    prob = [
        cons.execution_probability(j) if cons.conditional else 1.0
        for j in range(n)
    ]
    full = (1 << n) - 1
    INF = float("inf")
    # dp[mask][last] = min fitness of a path visiting `mask` ending at `last`.
    dp = [[INF] * n for _ in range(1 << n)]
    parent = [[-1] * n for _ in range(1 << n)]
    for s in range(n):
        if preds[s] == 0:
            dp[1 << s][s] = 0.0
    evaluated = 0
    for mask in range(1, full + 1):
        row = dp[mask]
        for last in range(n):
            cur = row[last]
            if cur == INF:
                continue
            for nxt in range(n):
                if mask & (1 << nxt):
                    continue
                if (preds[nxt] & mask) != preds[nxt]:
                    continue  # a prerequisite of nxt is still unvisited
                cand = cur + prob[nxt] * float(cost[last, nxt])
                nmask = mask | (1 << nxt)
                evaluated += 1
                if cand < dp[nmask][nxt]:
                    dp[nmask][nxt] = cand
                    parent[nmask][nxt] = last
    best_last = min(range(n), key=lambda t: dp[full][t])
    best_cost = dp[full][best_last]
    if best_cost == INF:
        raise ValueError("no permutation satisfies the precedence constraints")
    # Reconstruct.
    order: List[int] = []
    mask, last = full, best_last
    while last != -1:
        order.append(last)
        p = parent[mask][last]
        mask ^= 1 << last
        last = p
    order.reverse()
    return OrderingResult(tuple(order), best_cost, "held_karp", evaluated)


# --------------------------------------------------------------------------
# ILP formulation (Eq. 4-6) + branch-and-bound exact solver
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ILPFormulation:
    """Explicit matrix form of the paper's ILP (for inspection/testing).

    Variables are ``x[i, j]`` (Eq. 4) flattened row-major, plus the ``s[i,t]``
    start indicators (Eq. 5) implied by precedence timing (Eq. 6).  We
    materialise the objective vector and the two degree-constraint blocks; the
    exponential subtour-elimination family is represented lazily through
    :meth:`subtour_constraint` (standard row generation), which is how real
    ILP back-ends consume it too.
    """

    cost: np.ndarray

    @property
    def n(self) -> int:
        return self.cost.shape[0]

    def objective(self) -> np.ndarray:
        c = self.cost.astype(np.float64).copy()
        np.fill_diagonal(c, 0.0)
        return c.reshape(-1)

    def degree_constraints(self) -> Tuple[np.ndarray, np.ndarray]:
        """Rows ``A x = 1``: each task entered once and left once."""
        n = self.n
        a_in = np.zeros((n, n * n))
        a_out = np.zeros((n, n * n))
        for j in range(n):
            for i in range(n):
                if i != j:
                    a_in[j, i * n + j] = 1.0
                    a_out[i, i * n + j] = 1.0
        return a_in, a_out

    def subtour_constraint(self, subset: Sequence[int]) -> Tuple[np.ndarray, float]:
        """Row for ``sum_{i,j in Z} x_ij <= |Z| - 1`` (last block of Eq. 4)."""
        n = self.n
        row = np.zeros(n * n)
        for i in subset:
            for j in subset:
                if i != j:
                    row[i * n + j] = 1.0
        return row, float(len(subset) - 1)

    def check_assignment(self, x: np.ndarray) -> bool:
        """Degree feasibility of a 0/1 assignment (used by tests)."""
        a_in, a_out = self.degree_constraints()
        return bool(
            np.allclose(a_in @ x, 1.0) and np.allclose(a_out @ x, 1.0)
        )


def branch_and_bound_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
) -> OrderingResult:
    """Exact DFS branch-and-bound over the ILP's feasible set.

    Bound: current path cost + sum over unvisited tasks of their cheapest
    incoming expected edge — admissible, so the result is optimal.
    """
    n = cost.shape[0]
    cons = constraints or no_constraints(n)
    preds = [0] * n
    for (i, j) in cons.precedence:
        preds[j] |= 1 << i
    prob = np.array(
        [cons.execution_probability(j) if cons.conditional else 1.0 for j in range(n)]
    )
    c = cost.astype(np.float64)
    # cheapest expected in-edge per task (excluding self).
    masked = c + np.where(np.eye(n, dtype=bool), np.inf, 0.0)
    min_in = prob * masked.min(axis=0)

    best_cost = float("inf")
    best_order: Optional[Tuple[int, ...]] = None
    evaluated = 0

    order: List[int] = []

    def dfs(mask: int, last: int, acc: float) -> None:
        nonlocal best_cost, best_order, evaluated
        if len(order) == n:
            if acc < best_cost:
                best_cost, best_order = acc, tuple(order)
            return
        remaining = [t for t in range(n) if not (mask & (1 << t))]
        bound = acc + sum(min_in[t] for t in remaining)
        if bound >= best_cost:
            return
        for nxt in remaining:
            if (preds[nxt] & mask) != preds[nxt]:
                continue
            step = prob[nxt] * c[last, nxt] if last >= 0 else 0.0
            evaluated += 1
            order.append(nxt)
            dfs(mask | (1 << nxt), nxt, acc + step)
            order.pop()

    dfs(0, -1, 0.0)
    if best_order is None:
        raise ValueError("no permutation satisfies the precedence constraints")
    return OrderingResult(best_order, best_cost, "branch_and_bound", evaluated)


# --------------------------------------------------------------------------
# Greedy + 2-opt heuristic (for instances beyond the exact solvers' reach,
# e.g. the serving engine's inter-group ordering over many request groups)
# --------------------------------------------------------------------------

def greedy_2opt_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
) -> OrderingResult:
    """Nearest-neighbour seed + steepest-descent 2-opt/relocate polish.

    Heuristic path solver for the Eq. 7 objective: seeds a cheapest-next
    tour from every start task (precedence-respecting), keeps the best, then
    descends over segment reversals and single-element relocations until a
    local optimum.  O(n^2) seeding + O(n^2) moves per descent round — cheap
    enough for hundreds of nodes, where the exact solvers blow up.  The cost
    matrix may be asymmetric (the warm inter-group matrix is).
    """
    n = cost.shape[0]
    cons = constraints or no_constraints(n)
    if n == 1:
        return OrderingResult((0,), 0.0, "greedy_2opt", 1)
    preds: List[set] = [set() for _ in range(n)]
    for (i, j) in cons.precedence:
        preds[j].add(i)

    def nearest_neighbour(start: int) -> Optional[List[int]]:
        placed: List[int] = []
        placed_set: set = set()
        remaining = set(range(n))

        def ready():
            return [t for t in remaining if preds[t] <= placed_set]

        r = ready()
        if not r:
            return None
        cur = start if start in r else r[0]
        while True:
            placed.append(cur)
            placed_set.add(cur)
            remaining.remove(cur)
            if not remaining:
                return placed
            r = ready()
            if not r:
                return None  # dead end under precedence
            cur = min(r, key=lambda t: float(cost[placed[-1], t]))

    evaluated = 0
    seeds: List[Tuple[float, List[int]]] = []
    seen: set = set()
    for start in range(n):
        tour = nearest_neighbour(start)
        # Distinct starts can collapse to one tour (e.g. when precedence
        # pins the first node, as the group-ordering virtual start does) —
        # polishing duplicates is pure waste, so dedupe here.
        if tour is None or tuple(tour) in seen:
            continue
        seen.add(tuple(tour))
        evaluated += 1
        seeds.append((fitness(tour, cost, cons), tour))
    if not seeds:
        raise ValueError("no permutation satisfies the precedence constraints")
    seeds.sort(key=lambda s: s[0])

    def polish(order: np.ndarray, cur: float) -> Tuple[np.ndarray, float]:
        nonlocal evaluated
        improved = True
        while improved:
            improved = False
            for i in range(n - 1):
                for j in range(i + 1, n):
                    for kind in ("rev", "swap", "ins"):
                        cand = order.copy()
                        if kind == "rev":
                            cand[i:j + 1] = cand[i:j + 1][::-1]
                        elif kind == "swap":
                            cand[i], cand[j] = cand[j], cand[i]
                        else:  # relocate element i to position j
                            seg = cand[i]
                            cand = np.delete(cand, i)
                            cand = np.insert(cand, j, seg)
                        if not cons.is_valid_order(cand.tolist()):
                            continue
                        f = fitness(cand.tolist(), cost, cons)
                        evaluated += 1
                        if f < cur - 1e-12:
                            order, cur = cand, f
                            improved = True
        return order, cur

    # Polish a few diverse seeds, not just the cheapest: nearest-neighbour
    # ties/near-ties often descend into different local optima.
    best: Optional[np.ndarray] = None
    best_cost = float("inf")
    for f0, tour in seeds[:3]:
        order, f = polish(np.array(tour, dtype=np.int64), f0)
        if f < best_cost:
            best, best_cost = order, f
    return OrderingResult(
        tuple(int(t) for t in best), best_cost, "greedy_2opt", evaluated
    )


# --------------------------------------------------------------------------
# Subset re-solving (per-plan orders for the serving engine)
# --------------------------------------------------------------------------

def solve_suborder(
    cost: np.ndarray,
    tasks: Sequence[int],
    start_costs: Optional[Sequence[float]] = None,
    constraints: Optional[Constraints] = None,
    exact_limit: int = 9,
) -> List[int]:
    """Order a task *subset* of an existing cost matrix, warm-seeded.

    The serving engine solves one global order at startup, but a request
    group that wants only a subset of tasks — executed on an engine whose
    residency came from whatever ran before — can have a better internal
    order than the global order filtered to the subset.  This restricts
    ``cost`` to ``tasks``, keeps the precedence pairs of ``constraints``
    that fall entirely inside the subset, and (when ``start_costs`` is
    given, one entry per subset task) prepends a fixed virtual start node
    whose outgoing edges are those costs — the residency-aware "which task
    do we begin with" term, mirroring ``order_groups``'s warm start node
    one level down.

    Solved exactly (:func:`optimal_order`) up to ``exact_limit`` nodes,
    greedy + 2-opt beyond.  Returns the subset tasks in execution order
    (the virtual node stripped); a subset of one task is returned as-is.
    """
    tasks = [int(t) for t in tasks]
    m = len(tasks)
    if m <= 1:
        return list(tasks)
    if start_costs is not None and len(start_costs) != m:
        raise ValueError(
            f"{len(start_costs)} start costs for {m} subset tasks"
        )
    idx = {t: i for i, t in enumerate(tasks)}
    if len(idx) != m:
        raise ValueError(f"subset contains duplicate tasks: {tasks!r}")
    off = 1 if start_costs is not None else 0
    n = m + off
    c = np.zeros((n, n), dtype=np.float64)
    for i, a in enumerate(tasks):
        for j, b in enumerate(tasks):
            if i != j:
                c[i + off, j + off] = float(cost[a, b])
    prec: List[Tuple[int, int]] = []
    if start_costs is not None:
        for j in range(m):
            c[0, j + 1] = float(start_costs[j])
            prec.append((0, j + 1))  # the virtual start precedes everything
    if constraints is not None:
        for (a, b) in constraints.precedence:
            if a in idx and b in idx:
                prec.append((idx[a] + off, idx[b] + off))
    cons = Constraints.make(n, precedence=prec) if prec else None
    if n <= exact_limit:
        res = optimal_order(c, cons)
    else:
        res = greedy_2opt_order(c, cons)
    return [tasks[v - off] for v in res.order if v - off >= 0]


def optimal_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
    solver: str = "auto",
) -> OrderingResult:
    """Dispatch: brute force for tiny n, Held-Karp DP up to ~18, B&B beyond."""
    n = cost.shape[0]
    if solver == "brute_force" or (solver == "auto" and n <= 7):
        return brute_force_order(cost, constraints)
    if solver == "held_karp" or (solver == "auto" and n <= 18):
        return held_karp_order(cost, constraints)
    if solver == "greedy_2opt":
        return greedy_2opt_order(cost, constraints)
    return branch_and_bound_order(cost, constraints)
