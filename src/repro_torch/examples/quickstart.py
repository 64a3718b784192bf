"""Quickstart: the whole Antler pipeline on a 5-task workload, the PyTorch
port of ``examples/quickstart.py`` (no JAX needed).

1. define 5 classification tasks over one synthetic domain,
2. train per-task networks (200 SGD steps on the fully-separate LeNet-5
   program) and profile task affinity (inverse Pearson + Spearman, paper
   §3.1 — on CUDA each of the 15 profiles is one launch of the hand-written
   Pearson kernel),
3. enumerate task graphs, score variety vs execution cost, pick the
   tradeoff graph (paper §3.2-3.3),
4. solve the optimal task execution order (Held-Karp exact + GA, §4),
5. serve a batch through the block-cached executor and compare against the
   Vanilla baseline, measured and modelled (§6.1 baselines).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(the default device is ``cuda``).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, tree_leaves, tree_map
from repro_torch.configs.hardware import get_hardware
from repro_torch.core import (
    GAConfig, GraphCostModel, TaskGraph, TaskGraphExecutor, VanillaExecutor,
    genetic_order, optimal_order,
)
from repro_torch.core.affinity import affinity_matrix, profile_task
from repro_torch.core.baselines import antler_report, vanilla_baseline
from repro_torch.core.executor import MultitaskProgram
from repro_torch.core.tradeoff import TradeoffResult, select_task_graph
from repro_torch.core.types import HardwareModel
from repro_torch.data import MultitaskDataset, train_test_split
from repro_torch.models.cnn import build_lenet5_blocks
from repro_torch.models.multitask import (
    build_cnn_program, multitask_loss, program_trainable_params,
    program_with_params,
)
from repro_torch.training.optimizer import sgd_update

N_TASKS, N_CLASSES, N_BRANCH_POINTS = 5, 4, 3
TRAIN_STEPS, TRAIN_BATCH, LR = 200, 64, 0.05
N_PROBES = 64
HARDWARE = "msp430fr5994"


def loss_and_grads(
    program: MultitaskProgram, flat: Any, x: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, Any]:
    """The joint loss and its gradient tree (autograd), ``flat``'s layout.
    A leaf the loss does not read (a transformer backbone's unembedding)
    gets a zero gradient, as under JAX's ``value_and_grad``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(flat)]
    it = iter(leaves)
    params = tree_map(lambda _t: next(it), flat)
    loss = multitask_loss(program, params, x, labels)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    return loss.detach(), tree_map(lambda _t: next(grads), flat)


def train(
    program: MultitaskProgram,
    xtr: np.ndarray,
    ytr: np.ndarray,
    steps: int = TRAIN_STEPS,
    batch: int = TRAIN_BATCH,
    lr: float = LR,
    seed: int = 0,
) -> Tuple[Any, List[float]]:
    """Plain SGD on the joint multitask loss; minibatches drawn by
    ``np.random.default_rng(seed)``, as the reference draws them.  Returns
    the trained flat params and the loss of every step."""
    device = program.device
    flat = program_trainable_params(program)
    rng = np.random.default_rng(seed)
    losses = []
    for _step in range(steps):
        idx = rng.integers(0, xtr.shape[0], size=batch)
        loss, grads = loss_and_grads(
            program, flat,
            torch.as_tensor(xtr[idx], device=device),
            torch.as_tensor(ytr[:, idx], device=device),
        )
        flat = sgd_update(lr, grads, flat)
        losses.append(float(loss))
    return flat, losses


def branch_point_taps(
    program: MultitaskProgram, task: int, x: torch.Tensor,
    n_branch_points: int = N_BRANCH_POINTS,
) -> List[torch.Tensor]:
    """Representations at the branch points (after blocks 0..D-1) of one
    task's path, flattened per sample."""
    taps, h = [], x
    with torch.no_grad():
        for d, node in enumerate(program.graph.path(task)):
            if d == n_branch_points:
                break
            h = program.block_fns[d](program.node_params[node], h)
            taps.append(h.reshape(h.shape[0], -1))
    return taps


def profile(program: MultitaskProgram, probe: torch.Tensor) -> np.ndarray:
    """The (D, n, n) affinity tensor of the program's tasks on ``probe``."""
    profiles = [
        profile_task(branch_point_taps(program, t, probe))
        for t in range(program.graph.num_tasks)
    ]
    return affinity_matrix(profiles).cpu().numpy()


def select_and_order(
    aff: np.ndarray, hw: HardwareModel
) -> Tuple[TradeoffResult, Any, Any]:
    """Task-graph selection on the LeNet-5 costs, then the exact and the GA
    order of the selected graph."""
    _i, _a, costs, _f = build_lenet5_blocks()
    res = select_task_graph(N_TASKS, N_BRANCH_POINTS, aff, costs, hw)
    cm = GraphCostModel(res.selected.graph, costs, hw)
    exact = optimal_order(cm.cost_matrix())
    ga = genetic_order(cm.cost_matrix(), config=GAConfig(seed=0))
    return res, exact, ga


def serve_vs_vanilla(
    graph: TaskGraph, x: torch.Tensor, order: Sequence[int], hw: HardwareModel,
    device: torch.device,
) -> Dict[str, Any]:
    """One batch through the block-cached executor and Vanilla on a fresh
    program of ``graph``, with the modelled §6.1 reports beside them."""
    prog = build_cnn_program(
        graph, [N_CLASSES] * N_TASKS,
        generator=torch.Generator().manual_seed(1), device=device,
    )
    with torch.no_grad():
        _o, s_ant = TaskGraphExecutor(prog).run(x, list(order))
        _o, s_van = VanillaExecutor(prog).run(x, list(order))
    _i, _a, costs, _f = build_lenet5_blocks()
    return {
        "antler": s_ant, "vanilla": s_van,
        "antler_report": antler_report(graph, costs, hw, order),
        "vanilla_report": vanilla_baseline(N_TASKS, costs, hw),
    }


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    hw = get_hardware(HARDWARE)

    print("== 1. tasks over a shared domain ==")
    ds = MultitaskDataset(num_tasks=N_TASKS, num_classes=N_CLASSES, seed=0)
    (xtr, ytr), (xte, _yte) = train_test_split(ds, 2048, 512)
    print(f"domain X: {xtr.shape}, {N_TASKS} tasks x {N_CLASSES} classes")

    print("== 2. per-task training + affinity profiling ==")
    sep = TaskGraph.fully_separate(N_TASKS, N_BRANCH_POINTS)
    prog = build_cnn_program(
        sep, [N_CLASSES] * N_TASKS,
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    flat, losses = train(prog, xtr, ytr)
    print(f"per-task training done (first joint loss {losses[0]:.3f}, "
          f"final {losses[-1]:.3f})")
    trained = program_with_params(prog, flat)
    aff = profile(trained, torch.as_tensor(xte[:N_PROBES], device=dev))
    print("affinity S[0] (branch point 0):")
    print(np.round(aff[0], 2))

    print("== 3. task-graph selection (variety vs cost tradeoff) ==")
    res, exact, ga = select_and_order(aff, hw)
    sel = res.selected
    print(f"graphs evaluated: {len(res.candidates)}")
    print(f"selected graph partitions: {sel.graph.partitions}")
    print(f"variety={sel.variety:.3f} exec_cost={sel.exec_cost*1e3:.2f} ms "
          f"storage={sel.storage_bytes/1024:.0f} KB")

    print("== 4. optimal task ordering ==")
    print(f"exact order {exact.order} cost {exact.cost*1e3:.2f} ms | "
          f"GA order {ga.order} cost {ga.cost*1e3:.2f} ms")

    print("== 5. serve: block-cached executor vs Vanilla ==")
    served = serve_vs_vanilla(
        sel.graph, torch.as_tensor(xte[:8], device=dev), exact.order, hw, dev
    )
    s_ant, s_van = served["antler"], served["vanilla"]
    print(f"antler : {s_ant.blocks_executed} blocks executed, "
          f"{s_ant.blocks_skipped} skipped, {s_ant.seconds(hw)*1e3:.2f} ms predicted")
    print(f"vanilla: {s_van.blocks_executed} blocks executed, "
          f"{s_van.blocks_skipped} skipped, {s_van.seconds(hw)*1e3:.2f} ms predicted")
    print(f"speedup {s_van.seconds(hw)/s_ant.seconds(hw):.2f}x, "
          f"energy saving {100*(1-s_ant.energy(hw)/s_van.energy(hw)):.0f}%")
    a_rep, v_rep = served["antler_report"], served["vanilla_report"]
    print(f"modelled per input on {hw.name}: antler {a_rep.seconds*1e3:.2f} ms, "
          f"vanilla {v_rep.seconds*1e3:.2f} ms")
    return {
        "device": str(dev), "losses": losses, "aff": aff, "selection": res,
        "exact": exact, "ga": ga, **served,
    }


if __name__ == "__main__":
    main()
