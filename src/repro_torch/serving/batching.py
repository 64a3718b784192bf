"""Request grouping for the task-graph engine, the PyTorch port of the
multitask half of ``repro.serving.batching``.

:class:`RequestGroupScheduler` groups requests by requested task subset
(and input shape/dtype) so every group runs one homogeneous schedule through
``TaskGraphExecutor.run_batch``, and pads each group up to a small fixed set
of batch shapes by repeating its last row.  With a cost model supplied, the
groups are sequenced by :func:`order_groups` so consecutive groups hand
residency over cheaply.  Groups are stacked where the request inputs live
(numpy inputs stack on the CPU); the engine moves each group to the
program's device once.

:class:`ContinuousBatcher` serves LM generation requests (:class:`GenRequest`)
in waves of up to ``slots``: one prefill per wave, then batched greedy
decode steps until every member has its tokens.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (
    TYPE_CHECKING, Any, Deque, Dict, FrozenSet, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from repro_torch.core.constraints import Constraints
from repro_torch.core.cost_model import GraphCostModel
from repro_torch.core.ordering import greedy_2opt_order, optimal_order
from repro_torch.core.types import Residency
from repro_torch.models.registry import ModelApi
from repro_torch.sharding.policy import TP_POLICY, ShardingPolicy

if TYPE_CHECKING:  # avoid a module cycle with repro_torch.serving.engine
    from repro_torch.serving.engine import MultitaskRequest


DEFAULT_BATCH_SHAPES = (1, 4, 16, 64)


def normalize_subset(
    tasks: Optional[Sequence[int]], num_tasks: Optional[int] = None
) -> Optional[FrozenSet[int]]:
    """A request's task subset in bucket-key form: ``None`` for all-tasks —
    implicit, or explicit when ``num_tasks`` is known — a frozenset
    otherwise."""
    if tasks is None:
        return None
    subset = frozenset(int(t) for t in tasks)
    if num_tasks is not None and subset == frozenset(range(num_tasks)):
        return None
    return subset


@dataclasses.dataclass
class RequestGroup:
    """One homogeneous, padded execution group for ``run_batch``.

    Attributes:
      indices: positions of the member requests in the submitted sequence.
      requests: the member requests themselves (no padding entries).
      tasks: the shared requested task subset (``None`` = all tasks).
      xs: ``(P, *sample_shape)`` stacked inputs where ``P`` is one of the
        scheduler's padded batch shapes; rows ``valid:`` repeat the last real
        row and are dropped from outputs and logical accounting.
      valid: number of real leading rows (``len(requests)``).
      order: the group's resolved execution order, set by the engine's
        per-plan order re-solving pass; ``None`` means "the engine's global
        order filtered to ``tasks``".
    """

    indices: Tuple[int, ...]
    requests: Tuple["MultitaskRequest", ...]
    tasks: Optional[FrozenSet[int]]
    xs: torch.Tensor
    valid: int
    order: Optional[Tuple[int, ...]] = None


class RequestGroupScheduler:
    """Bucket + chunk + pad pending multitask requests into groups.

    Invariants: every submitted request lands in exactly one group; groups
    are homogeneous (same task subset, same input shape/dtype); every
    group's padded width is one of ``batch_shapes``; padded rows are
    replicas of the last real row, executed and then sliced away.  Arrival
    order is preserved within a bucket.

    ``shard_multiple`` rounds every allowed batch shape up to a multiple of
    the mesh's data-shard count (``ShardingPolicy.data_shards``) so a padded
    group always splits evenly over the batch axes — the engine folds this
    in automatically when given a mesh.
    """

    def __init__(
        self,
        batch_shapes: Sequence[int] = DEFAULT_BATCH_SHAPES,
        shard_multiple: int = 1,
    ):
        m = int(shard_multiple)
        if m < 1:
            raise ValueError(f"invalid shard multiple: {shard_multiple!r}")
        shapes = tuple(sorted({-(-int(s) // m) * m for s in batch_shapes}))
        if not shapes or shapes[0] < 1:
            raise ValueError(f"invalid batch shapes: {batch_shapes!r}")
        self.batch_shapes = shapes
        self.shard_multiple = m

    def chunk_sizes(self, n: int) -> List[Tuple[int, int]]:
        """Split a bucket of ``n`` requests into ``(take, padded_to)`` chunks.

        Greedy: peel off the largest allowed shape while it fits, and pad
        the remainder up to the next shape only when the padding does not
        exceed the remainder itself.  E.g. with shapes (1, 4, 16, 64):
        17 -> 16 + 1, 5 -> 4 + 1, 3 -> one chunk padded to 4.
        """
        out: List[Tuple[int, int]] = []
        while n > 0:
            up = next((s for s in self.batch_shapes if s >= n), None)
            down = max((s for s in self.batch_shapes if s <= n), default=None)
            if up is not None and (down is None or up - n <= n):
                out.append((n, up))
                break
            out.append((down, down))
            n -= down
        return out

    def plan(
        self,
        requests: Sequence["MultitaskRequest"],
        num_tasks: Optional[int] = None,
        cost_model: Optional[GraphCostModel] = None,
        task_order: Optional[Sequence[int]] = None,
        initial_resident: Optional[Residency] = None,
    ) -> List[RequestGroup]:
        """Partition ``requests`` into padded homogeneous groups.

        With ``num_tasks`` given, an explicit all-tasks subset is normalised
        to ``None``.  With ``cost_model`` and ``task_order`` given, the
        groups come back in the cost-aware inter-group sequence
        (:func:`order_groups`); otherwise bucket order is kept.
        ``initial_resident`` feeds the engine's current residency in so a
        warm engine also picks the cheapest first group.
        """
        buckets: Dict[Tuple, List[Tuple[int, Any, torch.Tensor]]] = {}
        for i, req in enumerate(requests):
            x = torch.as_tensor(req.x)
            subset = normalize_subset(req.tasks, num_tasks)
            key = (subset, tuple(x.shape), x.dtype, x.device)
            buckets.setdefault(key, []).append((i, req, x))

        groups: List[RequestGroup] = []
        for (subset, _shape, _dtype, _device), members in buckets.items():
            start = 0
            for take, p in self.chunk_sizes(len(members)):
                chunk = members[start:start + take]
                start += take
                rows = [x for (_i, _r, x) in chunk]
                rows.extend([rows[-1]] * (p - take))
                groups.append(RequestGroup(
                    indices=tuple(i for (i, _r, _x) in chunk),
                    requests=tuple(r for (_i, r, _x) in chunk),
                    tasks=subset,
                    xs=torch.stack(rows),
                    valid=take,
                ))
        if cost_model is not None and task_order is not None:
            groups = order_groups(
                groups, cost_model, task_order, initial_resident
            )
        return groups


# Above this many groups the exact path solvers get expensive; fall back to
# the greedy + 2-opt heuristic (the matrix is asymmetric either way).
EXACT_GROUP_ORDERING_LIMIT = 9


def effective_order(
    task_order: Sequence[int], tasks: Optional[FrozenSet[int]]
) -> List[int]:
    """The engine's task order filtered to one group's requested subset."""
    if tasks is None:
        return list(task_order)
    return [t for t in task_order if t in tasks]


def order_groups(
    groups: Sequence[RequestGroup],
    cost_model: GraphCostModel,
    task_order: Sequence[int],
    initial_resident: Optional[Residency] = None,
) -> List[RequestGroup]:
    """Cost-aware inter-group sequencing for the warm-start pipeline.

    The boundary cost of running group ``j`` right after group ``i`` is the
    load-only switching cost from ``i``'s last executed task to ``j``'s
    first, weighted by ``j``'s request count; the matrix goes through the
    ordering solvers (exact for few groups, greedy + 2-opt beyond
    ``EXACT_GROUP_ORDERING_LIMIT``).  ``initial_resident`` adds a fixed
    virtual start node so a warm engine also picks the cheapest *first*
    group.  Groups executing no tasks are appended at the end.
    """
    def group_eff(g: RequestGroup) -> List[int]:
        # A pre-resolved per-plan order wins over the filtered global order.
        if g.order is not None:
            return list(g.order)
        return effective_order(task_order, g.tasks)

    active = [i for i, g in enumerate(groups) if group_eff(g)]
    inert = [i for i in range(len(groups)) if i not in set(active)]
    m = len(active)
    if m <= 1:
        return [groups[i] for i in active + inert]
    firsts: List[int] = []
    lasts: List[int] = []
    for i in active:
        eff = group_eff(groups[i])
        firsts.append(eff[0])
        lasts.append(eff[-1])

    warm = initial_resident is not None and any(
        r is not None for r in initial_resident
    )
    n = m + 1 if warm else m
    off = 1 if warm else 0
    c = np.zeros((n, n), dtype=np.float64)
    for i in range(m):
        for j in range(m):
            if i == j:
                continue
            c[i + off, j + off] = (
                groups[active[j]].valid
                * cost_model.warm_switching_cost(lasts[i], firsts[j])
            )
    cons = None
    if warm:
        for j in range(m):
            c[0, j + 1] = groups[active[j]].valid * cost_model.resume_load_cost(
                initial_resident, firsts[j]
            )
        # The virtual start must come first: it precedes every group.
        cons = Constraints.make(n, precedence=[(0, j + 1) for j in range(m)])

    if n <= EXACT_GROUP_ORDERING_LIMIT:
        res = optimal_order(c, cons)
    else:
        res = greedy_2opt_order(c, cons)
    seq = [active[g - off] for g in res.order if g - off >= 0]
    return [groups[i] for i in seq + inert]


@dataclasses.dataclass
class GenRequest:
    uid: int
    prompt: np.ndarray          # (S0,) int32
    max_new_tokens: int


@dataclasses.dataclass
class GenResult:
    uid: int
    tokens: np.ndarray          # generated ids
    steps: int


class ContinuousBatcher:
    """Fixed-slot continuous batching over a :class:`ModelApi`.

    Requests are served in waves of up to ``slots`` in arrival order: the
    whole wave is prefilled together (simple and correct; a production
    engine would insert into the live cache), then decode steps are batched
    until every member has ``max_new_tokens`` tokens or emitted ``eos``.
    Prompts are right-aligned so every row's last prompt token sits at
    position ``s0 - 1``; the left padding repeats each prompt's first token,
    as the reference does.  The prefill goes through the model's own path
    (on CUDA, the flash kernel once per attention layer) and the cache is
    grown with the LM server's ``_grow_cache``.  ``policy`` is the
    reference's sharding policy (``TP_POLICY`` by default), passed to
    prefill and decode: with ``params`` on a mesh the waves run there, as
    :class:`~repro_torch.serving.engine.LMServer`'s batches do.
    """

    def __init__(
        self,
        model: ModelApi,
        params: Any,
        slots: int = 4,
        max_len: int = 256,
        eos_token: Optional[int] = None,
        *,
        policy: ShardingPolicy = TP_POLICY,
    ):
        self.model = model
        self.params = params
        self.policy = policy
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.queue: Deque[GenRequest] = deque()
        self.results: List[GenResult] = []

    def submit(self, req: GenRequest) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        self.queue.append(req)

    # ------------------------------------------------------------------ run
    def run(self) -> List[GenResult]:
        """Serve until the queue drains.  Returns completed results."""
        while self.queue:
            active = [
                self.queue.popleft()
                for _ in range(min(self.slots, len(self.queue)))
            ]
            self._serve_wave(active)
        return self.results

    @staticmethod
    def wave_tokens(active: Sequence[GenRequest]) -> np.ndarray:
        """A wave's prompts right-aligned and edge-padded: (B, s0) int32."""
        s0 = max(len(r.prompt) for r in active)
        return np.stack([
            np.pad(r.prompt, (s0 - len(r.prompt), 0), mode="edge")
            for r in active
        ]).astype(np.int32)

    def _serve_wave(self, active: List[GenRequest]) -> None:
        """Prefill a wave of requests together, decode until all finish."""
        from repro_torch.serving.engine import _grow_cache, greedy

        b = len(active)
        toks = self.wave_tokens(active)
        s0 = toks.shape[1]
        logits, cache = self.model.prefill(self.params, toks, self.policy)
        steps = max(r.max_new_tokens for r in active)
        cache = _grow_cache(self.model, cache, s0 + steps, s0, self.policy)

        out: Dict[int, List[int]] = {r.uid: [] for r in active}
        done = [False] * b
        tok = greedy(logits)
        cache_len = s0
        for _step in range(steps):
            ids = tok.cpu().numpy()
            for i, r in enumerate(active):
                if done[i]:
                    continue
                out[r.uid].append(int(ids[i]))
                if (
                    len(out[r.uid]) >= r.max_new_tokens
                    or (self.eos is not None and ids[i] == self.eos)
                ):
                    done[i] = True
            if all(done):
                break
            logits, cache = self.model.decode_step(
                self.params, tok, cache, cache_len, self.policy)
            tok = greedy(logits)
            cache_len += 1
        for r in active:
            self.results.append(GenResult(
                uid=r.uid, tokens=np.array(out[r.uid]), steps=len(out[r.uid])))
