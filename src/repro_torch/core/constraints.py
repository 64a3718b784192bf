"""Inter-task dependency constraints (paper §4.3).

*Precedence* constraints are static tuples ``(i, j)``: task ``i`` must finish
before task ``j`` starts.  *Conditional* constraints are triplets
``(i, j, p)`` — a special precedence edge where ``j`` only executes with
probability ``p`` once ``i``'s result is known; the ordering objective uses
the expected switching cost (paper Eq. 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Precedence set ``P`` and conditional set ``R`` over ``n`` tasks."""

    num_tasks: int
    precedence: FrozenSet[Tuple[int, int]] = frozenset()
    conditional: FrozenSet[Tuple[int, int, float]] = frozenset()

    @staticmethod
    def make(
        num_tasks: int,
        precedence: Iterable[Tuple[int, int]] = (),
        conditional: Iterable[Tuple[int, int, float]] = (),
    ) -> "Constraints":
        prec = set(tuple(p) for p in precedence)
        cond = set(tuple(c) for c in conditional)
        # Conditional constraints are a special type of precedence constraint
        # (paper §4.3), so their edges are included in the precedence set.
        for (i, j, _p) in cond:
            prec.add((i, j))
        c = Constraints(num_tasks, frozenset(prec), frozenset(cond))
        c.validate()
        return c

    def validate(self) -> None:
        for (i, j) in self.precedence:
            if not (0 <= i < self.num_tasks and 0 <= j < self.num_tasks):
                raise ValueError(f"precedence edge {(i, j)} out of range")
            if i == j:
                raise ValueError("self-precedence is not allowed")
        # Reject cyclic precedence (no valid order would exist).
        if self._has_cycle():
            raise ValueError("precedence constraints contain a cycle")

    def _has_cycle(self) -> bool:
        adj: Dict[int, list] = {i: [] for i in range(self.num_tasks)}
        for (i, j) in self.precedence:
            adj[i].append(j)
        color = [0] * self.num_tasks

        def dfs(u: int) -> bool:
            color[u] = 1
            for v in adj[u]:
                if color[v] == 1 or (color[v] == 0 and dfs(v)):
                    return True
            color[u] = 2
            return False

        return any(color[u] == 0 and dfs(u) for u in range(self.num_tasks))

    # ------------------------------------------------------------------ api
    def is_valid_order(self, order: Sequence[int]) -> bool:
        """Does the permutation satisfy every precedence edge (Eq. 6)?"""
        pos = {t: k for k, t in enumerate(order)}
        return all(pos[i] < pos[j] for (i, j) in self.precedence)

    def execution_probability(self, task: int) -> float:
        """P(``task`` executes): product of its conditional in-edges' probs.

        Tasks without conditional prerequisites always run (p = 1).  This is
        the expected-execution model behind Eq. 8: the switching cost into a
        conditionally-dependent task is weighted by how often it actually
        fires (estimated offline in the paper).
        """
        p = 1.0
        for (_i, j, pj) in self.conditional:
            if j == task:
                p *= pj
        return p

    @property
    def empty(self) -> bool:
        return not self.precedence and not self.conditional


NO_CONSTRAINTS = Constraints(num_tasks=0)


def no_constraints(num_tasks: int) -> Constraints:
    return Constraints(num_tasks=num_tasks)
