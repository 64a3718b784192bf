"""Optimizers and LR schedules, the PyTorch port of
``repro.training.optimizer``.

AdamW with decoupled weight decay and global-norm clipping, plus the
warmup-cosine schedule, over params trees (dicts, lists and tuples of
tensors, the layout of the reference's pytrees).  The moments are fp32
trees congruent with the params; the step is counted from 1.

Unlike the reference, which returns fresh moments, :func:`adamw_update`
updates ``state.mu`` and ``state.nu`` **in place** and returns them in the
new state: at full width the moments are 4x the bf16 params (29 GB for an
8-layer mistral-nemo-12b), and a second copy would not fit beside them.
The params come back as new tensors, leaf by leaf, so that no fp32 copy of
the whole tree is ever materialised; the caller's params stay as they were.

On a mesh the leaves are ``DTensor``s of mixed placements: each leaf's sum
of squares is reduced to the scalar every rank holds before the global
norm sums them, so the norm and the clip scale are the same on every
rank; the moments are allocated in their parameter's placements and every
update keeps them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import tree_leaves, tree_map
from repro_torch.sharding.utils import is_dtensor, on_mesh


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the CPU: the steps taken
    mu: Any             # first moment, fp32, the params' layout
    nu: Any             # second moment, fp32, the params' layout


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # "cosine" | "constant"


def lr_at(cfg: AdamWConfig, step: Any) -> float:
    """The learning rate at ``step``, in fp32 arithmetic as the reference's."""
    f32 = np.float32
    step = f32(int(step))
    warm = min(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    if cfg.schedule == "constant":
        return float(f32(cfg.lr) * warm)
    t = np.clip((step - f32(cfg.warmup_steps)) / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
    ratio = f32(cfg.min_lr_ratio)
    return float(f32(cfg.lr) * warm * (ratio + (f32(1.0) - ratio) * cos))


def _sum_sq(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's fp32 sum of squares as a plain 0-d tensor (on a mesh,
    reduced over the ranks)."""
    s = leaf.float().square().sum()
    return s.full_tensor() if is_dtensor(s) else s


def global_norm(tree: Any) -> torch.Tensor:
    """The fp32 L2 norm of every leaf together (a plain 0-d tensor)."""
    return torch.stack([_sum_sq(l) for l in tree_leaves(tree)]).sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``tree`` scaled so that its global norm is at most ``max_norm`` (each
    leaf scaled in fp32, cast back to its dtype), and the norm before."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    with on_mesh(tree):
        return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Any) -> AdamWState:
    """Zero fp32 moments in the params' layout (on a mesh, each in its
    parameter's placements) and step 0."""
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        mu=tree_map(zeros_f32, params),
        nu=tree_map(zeros_f32, params),
    )


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    metrics ``lr`` (a float) and ``grad_norm`` (a 0-d fp32 tensor, before
    clipping).  ``state``'s moments are updated in place (module doc).

    Leaf by leaf, as the reference: the clipped gradient cast back to its
    dtype, then in fp32 ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
    g^2``, ``delta = m_hat / (sqrt(v_hat) + eps)`` plus ``weight_decay *
    p`` on leaves of 2 or more dims, and ``(p - lr * delta)`` cast to the
    param's dtype."""
    gnorm = global_norm(grads)
    scale = None if cfg.clip_norm is None else _clip_scale(gnorm, cfg.clip_norm)
    step = int(state.step) + 1
    lr = lr_at(cfg, step)
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1.0) - f32(cfg.b2) ** f32(step))

    def upd(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        g32 = g.float() if scale is None else (g.float() * scale).to(g.dtype).float()
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        del g32
        denom = v.div(b2c).sqrt_().add_(cfg.eps)
        delta = m.div(b1c).div_(denom)
        del denom
        p32 = p.to(torch.float32, copy=True)  # never the caller's fp32 tensor
        if p.ndim >= 2:
            delta.add_(p32, alpha=cfg.weight_decay)
        return p32.sub_(delta, alpha=lr).to(p.dtype)

    grad_leaves = iter(tree_leaves(grads))
    mu_leaves = iter(tree_leaves(state.mu))
    nu_leaves = iter(tree_leaves(state.nu))
    with on_mesh(params):
        new_params = tree_map(
            lambda p: upd(p, next(grad_leaves), next(mu_leaves), next(nu_leaves)), params
        )
    new_state = AdamWState(step=torch.tensor(step, dtype=torch.int32), mu=state.mu, nu=state.nu)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def sgd_update(lr: float, grads: Any, params: Any) -> Any:
    """Plain SGD over a params tree: ``p - lr * g`` in fp32, cast back to
    each parameter's dtype.  ``grads`` has the layout of ``params``."""
    grad_leaves = iter(tree_leaves(grads))
    return tree_map(
        lambda p: (p.float() - lr * next(grad_leaves).float()).to(p.dtype),
        params,
    )
