"""Genetic-algorithm task-ordering solver (paper Appendix 9.2).

Faithful to the paper's description:

* individuals are permutations ``pi = (pi_1 .. pi_n)``;
* fitness is Eq. 7 (Eq. 8 under conditional constraints) — lower is better;
* each round selects the best ``K`` pairs by fitness, picks a random
  crossover point ``k`` and swaps the first ``k`` elements of the pair to
  produce offspring, mutates offspring by swapping two random positions, and
  discards individuals that are not valid orderings (non-permutations or
  precedence violations);
* terminates when the best fitness stops improving.

The paper's prefix-swap crossover usually produces non-permutations (which
are then discarded), so convergence leans on mutation.  We additionally
provide an *order-crossover* (OX) repair mode — a standard TSP-GA operator —
as a beyond-paper improvement; benchmarks report both
(``crossover='paper'`` vs ``crossover='ox'``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.constraints import Constraints, no_constraints
from repro_torch.core.ordering import OrderingResult, fitness


@dataclasses.dataclass(frozen=True)
class GAConfig:
    population: int = 128
    elite_pairs: int = 32          # the paper's "best K pairs"
    mutation_rate: float = 0.9
    patience: int = 40             # rounds without improvement before stop
    max_rounds: int = 600
    crossover: str = "ox"          # "paper" (prefix swap) or "ox" (repairing)
    nn_seed: bool = True           # seed with nearest-neighbour tours
    reversal_mutation: bool = True # 2-opt-style segment reversal mutation
    local_search: bool = True      # memetic 2-opt polish of the GA best
    seed: int = 0


def _is_permutation(ind: np.ndarray, n: int) -> bool:
    return len(np.unique(ind)) == n


def _prefix_swap(a: np.ndarray, b: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The paper's crossover: swap the first k elements of the pair."""
    ca, cb = a.copy(), b.copy()
    ca[:k], cb[:k] = b[:k].copy(), a[:k].copy()
    return ca, cb


def _order_crossover(a: np.ndarray, b: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """OX: child keeps a's prefix, fills the rest in b's relative order."""
    def ox(p: np.ndarray, q: np.ndarray) -> np.ndarray:
        head = p[:k]
        tail = [t for t in q if t not in set(head.tolist())]
        return np.concatenate([head, np.array(tail, dtype=p.dtype)])

    return ox(a, b), ox(b, a)


def _random_valid_order(
    rng: np.random.Generator, cons: Constraints, n: int
) -> np.ndarray:
    """Random topological order respecting precedence (seed individuals)."""
    preds = {j: set() for j in range(n)}
    for (i, j) in cons.precedence:
        preds[j].add(i)
    placed: List[int] = []
    remaining = set(range(n))
    while remaining:
        ready = [t for t in remaining if preds[t] <= set(placed)]
        t = int(rng.choice(ready))
        placed.append(t)
        remaining.remove(t)
    return np.array(placed, dtype=np.int64)


def _nearest_neighbour_order(
    cost: np.ndarray, start: int, cons: Constraints, n: int
) -> np.ndarray:
    """Greedy cheapest-next tour respecting precedence (seed individuals)."""
    preds = {j: set() for j in range(n)}
    for (i, j) in cons.precedence:
        preds[j].add(i)
    placed: List[int] = []
    remaining = set(range(n))

    def ready():
        return [t for t in remaining if preds[t] <= set(placed)]

    r = ready()
    cur = start if start in r else r[0]
    placed.append(cur)
    remaining.remove(cur)
    while remaining:
        r = ready()
        cur = min(r, key=lambda t: cost[cur, t])
        placed.append(cur)
        remaining.remove(cur)
    return np.array(placed, dtype=np.int64)


def genetic_order(
    cost: np.ndarray,
    constraints: Optional[Constraints] = None,
    config: Optional[GAConfig] = None,
) -> OrderingResult:
    """Solve the ordering problem with the Appendix-9.2 genetic algorithm."""
    cfg = config or GAConfig()
    n = cost.shape[0]
    cons = constraints or no_constraints(n)
    rng = np.random.default_rng(cfg.seed)

    if n == 1:
        return OrderingResult((0,), 0.0, "genetic", 1)

    pop = [_random_valid_order(rng, cons, n) for _ in range(cfg.population)]
    if cfg.nn_seed:
        # Seed a nearest-neighbour tour from every start task: strong,
        # diverse elites that OX recombines toward the optimum.
        pop[:n] = [
            _nearest_neighbour_order(cost, s, cons, n) for s in range(min(n, len(pop)))
        ]

    def fit(ind: np.ndarray) -> float:
        return fitness(ind.tolist(), cost, cons)

    evaluated = 0
    best = min(pop, key=fit)
    best_cost = fit(best)
    stale = 0

    for _round in range(cfg.max_rounds):
        scored = sorted(pop, key=fit)
        evaluated += len(pop)
        children: List[np.ndarray] = []
        # best K pairs by fitness: consecutive elites (1,2), (3,4), ...
        for p in range(cfg.elite_pairs):
            i, j = 2 * p, 2 * p + 1
            if j >= len(scored):
                break
            k = int(rng.integers(1, n))  # crossover point in {1..n-1}
            if cfg.crossover == "paper":
                ca, cb = _prefix_swap(scored[i], scored[j], k)
            else:
                ca, cb = _order_crossover(scored[i], scored[j], k)
            for child in (ca, cb):
                child = child.copy()
                if rng.random() < cfg.mutation_rate:
                    if cfg.reversal_mutation and rng.random() < 0.5:
                        # 2-opt-style segment reversal.
                        m1, m2 = sorted(rng.integers(0, n, size=2))
                        child[m1:m2 + 1] = child[m1:m2 + 1][::-1]
                    else:
                        m1, m2 = rng.integers(0, n, size=2)
                        child[m1], child[m2] = child[m2], child[m1]
                # Discard invalid individuals (non-permutation or precedence
                # violation) — the paper's final filtering step.
                if not _is_permutation(child, n):
                    continue
                if not cons.is_valid_order(child.tolist()):
                    continue
                children.append(child)

        # Next generation: elites survive, children compete, random refresh.
        keep = scored[: cfg.population - len(children) - 4]
        refresh = [_random_valid_order(rng, cons, n) for _ in range(4)]
        pop = keep + children + refresh

        cur = min(pop, key=fit)
        cur_cost = fit(cur)
        if cur_cost < best_cost - 1e-12:
            best, best_cost = cur.copy(), cur_cost
            stale = 0
        else:
            stale += 1
            if stale >= cfg.patience:
                break

    if cfg.local_search:
        best, best_cost, extra = _two_opt_polish(best, best_cost, cost, cons)
        evaluated += extra
    return OrderingResult(tuple(int(t) for t in best), best_cost, "genetic", evaluated)


def _two_opt_polish(
    ind: np.ndarray, cur: float, cost: np.ndarray, cons: Constraints
) -> Tuple[np.ndarray, float, int]:
    """Memetic finishing move: steepest-descent over segment reversals and
    pair swaps until a local optimum (validity-checked under precedence)."""
    n = len(ind)
    evaluated = 0
    improved = True
    best = ind.copy()
    while improved:
        improved = False
        for i in range(n - 1):
            for j in range(i + 1, n):
                for kind in ("rev", "swap", "ins"):
                    cand = best.copy()
                    if kind == "rev":
                        cand[i:j + 1] = cand[i:j + 1][::-1]
                    elif kind == "swap":
                        cand[i], cand[j] = cand[j], cand[i]
                    else:  # Or-opt: relocate element i to position j
                        seg = cand[i]
                        cand = np.delete(cand, i)
                        cand = np.insert(cand, j, seg)
                    if not cons.is_valid_order(cand.tolist()):
                        continue
                    f = fitness(cand.tolist(), cost, cons)
                    evaluated += 1
                    if f < cur - 1e-12:
                        best, cur = cand, f
                        improved = True
    return best, cur, evaluated
