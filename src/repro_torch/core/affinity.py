"""Task-affinity computation (paper §3.1), the PyTorch port of
``repro.core.affinity``.

Step 1 (per task): profile the task's network at ``D`` branch points over
``K`` samples.  At each branch point the pairwise *dissimilarity* between the
representations of every pair of samples is the **inverse Pearson
correlation** ``1 - r``; this yields a ``D x K x K`` profile tensor per task.
:func:`profile_task` computes it through
:func:`repro_torch.kernels.ops.pairwise_pearson_dissimilarity`, so a CUDA
input launches the hand-written Pearson kernel.

Step 2 (per task pair): at each branch point, the **Spearman rank
correlation** between the two tasks' flattened ``K x K`` profiles gives the
affinity ``S[d, i, j]`` -> a ``D x n x n`` affinity tensor.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.kernels import ops


def _standardize_rows(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Center each row and scale it to unit L2 norm (Pearson normalisation)."""
    return ops.standardize_rows(x, eps)


def pairwise_pearson_dissimilarity(feats: torch.Tensor) -> torch.Tensor:
    """``1 - Pearson(r_i, r_j)`` for all sample pairs.

    Args:
      feats: ``(K, F)`` representations of ``K`` samples at one branch point.

    Returns:
      ``(K, K)`` fp32 dissimilarity matrix in ``[0, 2]``.
    """
    return ops.pairwise_pearson_dissimilarity(feats)


def _rankdata(x: torch.Tensor) -> torch.Tensor:
    """Average-tie ranks (fp32) of a 1-D tensor, as the reference computes
    them: stable argsort, then each tie group's summed ranks over its size."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    positions = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    sorted_x = x[order]
    new_group = torch.ones(n, dtype=torch.bool, device=x.device)
    new_group[1:] = sorted_x[1:] != sorted_x[:-1]
    group_id = torch.cumsum(new_group, 0) - 1
    group_sum = torch.zeros(n, dtype=torch.float32, device=x.device)
    group_sum.scatter_add_(0, group_id, positions)
    group_cnt = torch.zeros(n, dtype=torch.float32, device=x.device)
    group_cnt.scatter_add_(0, group_id, torch.ones_like(positions))
    mean_rank = group_sum / torch.clamp(group_cnt, min=1.0)
    ranks = torch.empty(n, dtype=torch.float32, device=x.device)
    ranks[order] = mean_rank[group_id]
    return ranks


def _centred_ranks(profile: torch.Tensor) -> torch.Tensor:
    r = _rankdata(profile.reshape(-1))
    return r - r.mean()


def _correlate(ra: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    denom = torch.linalg.vector_norm(ra) * torch.linalg.vector_norm(rb)
    corr = torch.dot(ra, rb) / torch.clamp(denom, min=1e-12)
    return torch.where(denom > 0, corr, torch.zeros_like(corr))


def spearman(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation between two flattened profile vectors."""
    return _correlate(_centred_ranks(a), _centred_ranks(b))


def profile_task(reps_at_branch_points: Sequence[torch.Tensor]) -> torch.Tensor:
    """Step 1 for one task: stack per-branch-point ``K x K`` dissimilarities.

    Args:
      reps_at_branch_points: length-``D`` list of ``(K, F_d)`` representation
        matrices captured at each branch point (``F_d`` may differ per depth).

    Returns:
      ``(D, K, K)`` profile tensor.
    """
    return torch.stack([
        pairwise_pearson_dissimilarity(r.reshape(r.shape[0], -1))
        for r in reps_at_branch_points
    ])


def affinity_matrix(profiles: Sequence[torch.Tensor]) -> torch.Tensor:
    """Step 2: ``(D, n, n)`` Spearman affinity between all task pairs.

    Args:
      profiles: length-``n`` list of ``(D, K, K)`` profile tensors.

    Returns:
      ``S`` with ``S[d, i, j]`` = Spearman correlation of tasks i, j's
      branch-point-``d`` profiles.  Each profile is ranked once and every
      pair correlates those ranks — the same values as :func:`spearman` per
      pair.
    """
    profs = torch.stack(list(profiles))  # (n, D, K, K)
    n, depth = profs.shape[0], profs.shape[1]
    rows = []
    for d in range(depth):
        ranks = [_centred_ranks(profs[i, d]) for i in range(n)]
        rows.append(torch.stack([
            torch.stack([_correlate(ranks[i], ranks[j]) for j in range(n)])
            for i in range(n)
        ]))
    return torch.stack(rows)


def compute_affinity(
    apply_with_taps: Callable[[torch.Tensor, int], List[torch.Tensor]],
    num_tasks: int,
    samples: torch.Tensor,
) -> torch.Tensor:
    """End-to-end affinity: profile every task on ``samples`` then correlate.

    Args:
      apply_with_taps: ``f(samples, task_idx) -> [reps at D branch points]``;
        each element is ``(K, ...)``.
      num_tasks: number of tasks ``n``.
      samples: ``(K, ...)`` probe batch drawn from the shared domain ``X``.

    Returns:
      ``(D, n, n)`` affinity tensor (Spearman, in ``[-1, 1]``).
    """
    profiles = [
        profile_task(apply_with_taps(samples, t)) for t in range(num_tasks)
    ]
    return affinity_matrix(profiles)
