"""Task graphs (paper §2.2, §3): structure, enumeration, variety score.

A *task graph* over ``n`` tasks and ``D`` branch points is a tree of depth
``D + 1`` below a virtual root:

* depth ``0 .. D`` nodes are *blocks* of the common network architecture
  (``D + 1`` blocks along every root->leaf path — the paper's deployment
  uses 4 blocks for 3 branch points);
* every task owns exactly one root->leaf path; a node is shared by the set
  of tasks whose paths pass through it;
* sharing is prefix-closed: two tasks sharing a depth-``d`` block share all
  blocks above it.

Equivalently, a task graph is a chain of nested partitions
``P_0 ⊒ P_1 ⊒ ... ⊒ P_D`` of the task set, where ``P_d`` groups tasks that
share the depth-``d`` block.  We use that canonical representation: it makes
deduplication, hashing and variety computation trivial.

The enumeration (paper §3.3 Step 2) grows graphs recursively: every graph on
``n-1`` tasks yields one new graph per *internal attach point* for the n-th
task.  In partition form, attaching at depth ``d`` means: task ``n`` joins an
existing group for all depths ``< d`` and forms singleton groups from depth
``d`` on — plus the choice of *which* existing group it joins along the way.
The count explodes combinatorially (it is the number of nested partition
chains), so for ``n`` beyond ~6 tasks the generator supports beam pruning by
variety score (an adaptation noted in DESIGN.md; the paper enumerates fully
for its 5-task example).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# A partition is a tuple of groups; each group is a sorted tuple of task ids.
Partition = Tuple[Tuple[int, ...], ...]


def _canon(groups: Iterable[Iterable[int]]) -> Partition:
    gs = [tuple(sorted(g)) for g in groups if len(tuple(g)) > 0]
    return tuple(sorted(gs))


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """Canonical nested-partition representation of a task graph.

    Attributes:
      num_tasks: ``n``.
      partitions: length ``D + 1`` tuple; ``partitions[d]`` is the partition
        of tasks into groups sharing the depth-``d`` block.  ``partitions[d+1]``
        refines ``partitions[d]``.
    """

    num_tasks: int
    partitions: Tuple[Partition, ...]

    # ------------------------------------------------------------------ api
    @property
    def depth(self) -> int:
        """Number of blocks along each path (= D + 1)."""
        return len(self.partitions)

    @property
    def num_branch_points(self) -> int:
        return self.depth - 1

    def group_of(self, depth: int, task: int) -> Tuple[int, ...]:
        for g in self.partitions[depth]:
            if task in g:
                return g
        raise KeyError(f"task {task} not in partition at depth {depth}")

    def nodes(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """All blocks as ``(depth, group)`` pairs."""
        return [
            (d, g) for d, part in enumerate(self.partitions) for g in part
        ]

    def num_blocks(self) -> int:
        return len(self.nodes())

    def path(self, task: int) -> List[Tuple[int, Tuple[int, ...]]]:
        """The root->leaf chain of blocks executed by ``task``."""
        return [(d, self.group_of(d, task)) for d in range(self.depth)]

    def shared_prefix_depth(self, i: int, j: int) -> int:
        """Number of leading blocks shared by tasks ``i`` and ``j``."""
        shared = 0
        for d in range(self.depth):
            if self.group_of(d, i) == self.group_of(d, j):
                shared += 1
            else:
                break
        return shared

    def branch_nodes(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """Nodes under which tasks diverge (used by the variety score).

        A ``(depth, group)`` node is a *branch point node* if the group splits
        into >= 2 child groups at ``depth + 1`` (or, at the final depth, still
        holds >= 2 tasks — they diverge into per-task heads there).
        """
        out = []
        for d, g in self.nodes():
            if len(g) < 2:
                continue
            if d == self.depth - 1:
                out.append((d, g))
            else:
                children = self.children_of(d, g)
                if len(children) >= 2:
                    out.append((d, g))
        # The virtual root is a branch node if depth-0 has >= 2 groups.
        if len(self.partitions[0]) >= 2:
            out.append((-1, tuple(sorted(range(self.num_tasks)))))
        return out

    def children_of(self, depth: int, group: Tuple[int, ...]) -> List[Tuple[int, ...]]:
        if depth == -1:
            return list(self.partitions[0])
        if depth == self.depth - 1:
            return [(t,) for t in group]
        return [g for g in self.partitions[depth + 1] if set(g) <= set(group)]

    def validate(self) -> None:
        all_tasks = set(range(self.num_tasks))
        prev: Optional[Partition] = None
        for d, part in enumerate(self.partitions):
            seen = [t for g in part for t in g]
            if sorted(seen) != sorted(all_tasks):
                raise ValueError(f"partition at depth {d} is not a partition")
            if prev is not None:
                for g in part:
                    if not any(set(g) <= set(pg) for pg in prev):
                        raise ValueError(
                            f"partition at depth {d} does not refine depth {d-1}"
                        )
            prev = part

    # ------------------------------------------------------------- factories
    @staticmethod
    def fully_shared(num_tasks: int, num_branch_points: int) -> "TaskGraph":
        """Fig. 2 left: one group everywhere (most compact, max variety)."""
        g = _canon([range(num_tasks)])
        return TaskGraph(num_tasks, tuple(g for _ in range(num_branch_points + 1)))

    @staticmethod
    def fully_separate(num_tasks: int, num_branch_points: int) -> "TaskGraph":
        """Fig. 2 right: singleton groups everywhere (no sharing)."""
        g = _canon([[t] for t in range(num_tasks)])
        return TaskGraph(num_tasks, tuple(g for _ in range(num_branch_points + 1)))

    @staticmethod
    def from_groups(groups: Sequence[Sequence[Sequence[int]]]) -> "TaskGraph":
        parts = tuple(_canon(p) for p in groups)
        n = sum(len(g) for g in parts[0])
        tg = TaskGraph(n, parts)
        tg.validate()
        return tg


# --------------------------------------------------------------------------
# Enumeration (paper §3.3 Step 2)
# --------------------------------------------------------------------------

def _attachments(graph: TaskGraph, new_task: int) -> Iterator[TaskGraph]:
    """All graphs obtained by branching ``new_task`` out of one internal node.

    Attaching under the node ``(d, g)`` means the new task shares blocks with
    group ``g`` at depths ``0..d`` and runs fresh singleton blocks below.
    Attaching at the virtual root (d = -1) shares nothing.
    """
    depth = graph.depth
    seen = set()

    def emit(parts: List[List[List[int]]]) -> Optional[TaskGraph]:
        tg = TaskGraph(graph.num_tasks + 1, tuple(_canon(p) for p in parts))
        key = tg.partitions
        if key in seen:
            return None
        seen.add(key)
        return tg

    # Virtual-root attachment: new singleton chain all the way down.
    parts = [
        [list(g) for g in graph.partitions[d]] + [[new_task]]
        for d in range(depth)
    ]
    tg = emit(parts)
    if tg is not None:
        yield tg

    # Attachment under each internal (non-leaf) node (d, g): share through d.
    for d in range(depth - 1):  # leaves (final depth) are not attach points
        for g in graph.partitions[d]:
            parts = []
            for dd in range(depth):
                layer = [list(x) for x in graph.partitions[dd]]
                if dd <= d:
                    # Join the group at depth dd that contains g (a superset
                    # of g by the nesting property) -> prefix sharing.
                    for x in layer:
                        if set(g) <= set(x):
                            x.append(new_task)
                            break
                else:
                    layer.append([new_task])
                parts.append(layer)
            tg = emit(parts)
            if tg is not None:
                yield tg


def enumerate_task_graphs(
    num_tasks: int,
    num_branch_points: int,
    beam: Optional[int] = None,
    variety_fn=None,
) -> List[TaskGraph]:
    """All task graphs on ``num_tasks`` tasks (paper §3.3 Step 2).

    Grows graphs one task at a time, deduplicating by canonical form.  With
    ``beam`` set, only the ``beam`` best graphs (by ``variety_fn``) survive
    each growth round — needed for n >= ~7 where the full set explodes.
    """
    frontier: Dict[Tuple[Partition, ...], TaskGraph] = {}
    g0 = TaskGraph.from_groups([[[0]] for _ in range(num_branch_points + 1)])
    frontier[g0.partitions] = g0
    for t in range(1, num_tasks):
        nxt: Dict[Tuple[Partition, ...], TaskGraph] = {}
        for g in frontier.values():
            for tg in _attachments(g, t):
                nxt[tg.partitions] = tg
        graphs = list(nxt.values())
        if beam is not None and len(graphs) > beam and variety_fn is not None:
            # Diversity-preserving beam: bucket by block count (a storage
            # proxy) and keep the lowest-variety graphs per bucket, so the
            # downstream tradeoff curve still spans compact <-> separate
            # graphs instead of collapsing to one end.
            buckets: Dict[int, List[TaskGraph]] = {}
            for g in graphs:
                buckets.setdefault(g.num_blocks(), []).append(g)
            per = max(beam // max(len(buckets), 1), 1)
            kept: List[TaskGraph] = []
            for bs in buckets.values():
                bs.sort(key=variety_fn)
                kept.extend(bs[:per])
            graphs = kept[:beam]
        frontier = {g.partitions: g for g in graphs}
    out = list(frontier.values())
    for g in out:
        g.validate()
    return out


# --------------------------------------------------------------------------
# Variety score (paper Eq. 1-2)
# --------------------------------------------------------------------------

def variety_at_branch_point(
    affinity: np.ndarray, depth: int, groups: Sequence[Tuple[int, ...]]
) -> float:
    """Eq. 1: ``v_rho = (1/m) sum_k max_{i,j in c_k} (1 - S[rho,i,j])``.

    ``affinity`` is the ``(D, n, n)`` Spearman tensor; ``groups`` are the
    child branches at this branch point — the groups of tasks still sharing
    a block at this depth.  This is the intra-cluster-impurity analogy the
    paper draws: a group with dissimilar tasks is a misfit.  A singleton
    group contributes 0 (a single task has no internal dissimilarity), so
    the fully-separate graph scores 0 (lowest) and the fully-shared graph
    the per-depth max (highest) — exactly Fig. 2.
    """
    d_idx = int(np.clip(depth, 0, affinity.shape[0] - 1))
    s = affinity[d_idx]
    vals = []
    for ck in groups:
        if len(ck) < 2:
            vals.append(0.0)
            continue
        worst = max(
            1.0 - float(s[i, j]) for i, j in itertools.combinations(ck, 2)
        )
        vals.append(worst)
    return float(np.mean(vals)) if vals else 0.0


def variety_score(graph: TaskGraph, affinity: np.ndarray) -> float:
    """Eq. 2: sum over branch points of the per-depth group impurity.

    The partition at depth ``d`` is what the branch point above it decided,
    so the variety score sums ``variety_at_branch_point`` over every depth's
    partition (affinity rows are clipped to the profiled branch points).
    """
    total = 0.0
    for d, part in enumerate(graph.partitions):
        total += variety_at_branch_point(affinity, d, part)
    return total
