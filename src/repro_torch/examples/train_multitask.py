"""Antler's retraining of the selected task graph (paper §2.2): a ~100M
parameter multitask transformer trained for a few hundred steps, the
PyTorch port of ``examples/train_multitask.py`` (no JAX needed).

The backbone is a reduced granite-family decoder (8 layers, d_model 768,
GQA 12/4, SwiGLU d_ff 2048, vocab 32768, fp32); Antler's task graph
attaches 4 classification branches over its blocks, and the joint branched
multitask loss retrains the graph with AdamW.  Each task-graph node runs
once a step (``multitask_forward`` memoises by node): on CUDA every
attention layer of a node launches the hand-written flash kernel forward
and, in the backward, its backward kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_multitask
      [--steps N --batch B --seq S --device cpu]  (the default device is ``cuda``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, tree_leaves
from repro_torch.core import TPU_V5E, GraphCostModel, TaskGraph, optimal_order
from repro_torch.core.executor import MultitaskProgram
from repro_torch.data import lm_batches
from repro_torch.examples.quickstart import loss_and_grads
from repro_torch.models.config import ModelConfig, make_config
from repro_torch.models.multitask import build_transformer_program, program_trainable_params
from repro_torch.training.optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

# The selected graph: all four tasks share block 0, pairs share block 1,
# tasks 0 and 1 share block 2, every task owns block 3.
GRAPH_GROUPS = (
    [[0, 1, 2, 3]],
    [[0, 1], [2, 3]],
    [[0, 1], [2], [3]],
    [[0], [1], [2], [3]],
)
N_CLASSES = (4, 4, 8, 2)
LR, WARMUP = 1e-4, 20
LOG_EVERY = 25


def backbone_config(**overrides: Any) -> ModelConfig:
    """The ~100M-param granite-family backbone (8 layers, d 768, SwiGLU,
    fp32, no remat); ``overrides`` shrink it for a test."""
    fields = dict(
        name="granite-100m", family="dense", num_layers=8, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
        dtype="float32", param_dtype="float32", remat=False,
        attn_chunk=64, loss_chunk=64,
    )
    fields.update(overrides)
    return make_config(**fields)


def task_graph() -> TaskGraph:
    return TaskGraph.from_groups([list(g) for g in GRAPH_GROUPS])


def build_program(cfg: ModelConfig, seq: int, device: torch.device,
                  seed: int = 0) -> MultitaskProgram:
    """The multitask program of :func:`task_graph` over ``cfg``, its weights
    drawn on ``device`` from a generator seeded with ``seed``."""
    return build_transformer_program(
        task_graph(), cfg, list(N_CLASSES), seq_len=seq,
        generator=torch.Generator(device=device).manual_seed(seed), device=device,
    )


def serving_order(program: MultitaskProgram) -> List[int]:
    """The exact (Held-Karp) order of the branches on the TPU_V5E cost model,
    as the reference solves it."""
    cm = GraphCostModel(program.graph, program.block_costs, TPU_V5E)
    return list(optimal_order(cm.cost_matrix()).order)


def task_labels(tokens: np.ndarray, n_classes: Sequence[int] = N_CLASSES) -> np.ndarray:
    """Synthetic branch labels each task can learn: task t classifies the
    token at position -(t+1) modulo its class count.  (T, B) int32."""
    tokens = np.asarray(tokens)
    return np.stack([tokens[:, -(t + 1)] % c for t, c in enumerate(n_classes)]).astype(np.int32)


def make_train_step(
    program: MultitaskProgram, opt_cfg: AdamWConfig,
) -> Callable[[Any, AdamWState, Any, Any], Tuple[Any, AdamWState, float, float]]:
    """``step(flat, opt, tokens, labels) -> (flat, opt, loss, grad_norm)``:
    one AdamW step on the joint loss, the reference's ``train_step``."""
    device = program.device

    def step(flat, opt, tokens, labels):
        tokens = torch.as_tensor(np.asarray(tokens), device=device)
        labels = torch.as_tensor(np.asarray(labels), device=device)
        loss, grads = loss_and_grads(program, flat, tokens, labels)
        flat, opt, metrics = adamw_update(opt_cfg, grads, opt, flat)
        return flat, opt, float(loss), float(metrics["grad_norm"])

    return step


def train(
    program: MultitaskProgram, vocab_size: int, steps: int, batch: int, seq: int,
    log: Optional[Callable[[str], None]] = print,
) -> Dict[str, Any]:
    """``steps`` AdamW steps (lr 1e-4, warmup 20) on ``lm_batches(seed=0)``
    and :func:`task_labels`.  Returns the trained flat params, the optimizer
    state, and each step's loss, grad norm and wall seconds (to a device
    sync)."""
    flat = program_trainable_params(program)
    opt = adamw_init(flat)
    step_fn = make_train_step(program, AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=steps))
    it = lm_batches(vocab_size, batch=batch, seq_len=seq, seed=0)
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        tokens = next(it)
        s0 = time.perf_counter()
        flat, opt, loss, gnorm = step_fn(flat, opt, tokens, task_labels(tokens))
        history.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "seconds": time.perf_counter() - s0})
        if log is not None and (step % LOG_EVERY == 0 or step == steps - 1):
            log(f"step {step:4d} loss {loss:.4f} gnorm {gnorm:.3f} "
                f"({time.perf_counter() - t0:.0f}s)")
    return {"flat": flat, "opt": opt, "history": history}


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=128)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = backbone_config()
    program = build_program(cfg, args.seq, dev)
    n_params = sum(t.numel() for t in tree_leaves(program_trainable_params(program)))
    print(f"multitask transformer: {n_params / 1e6:.1f}M params, "
          f"{len(program.node_params)} task-graph nodes")
    order = serving_order(program)
    print(f"optimal serving order for the branches: {order}")
    out = train(program, cfg.vocab_size, args.steps, args.batch, args.seq)
    print("done.")
    return {"device": str(dev), "params": n_params, "order": order, **out}


if __name__ == "__main__":
    main()
