"""Empirical block profiling (paper §5.3, step 1), the PyTorch port of
``repro.core.profiler``.

Times each block of a :class:`~repro_torch.core.executor.MultitaskProgram`
family on its device, counts its weight bytes, and emits
:class:`~repro_torch.core.types.BlockCost` entries whose ``flops`` are
calibrated so that the analytic cost model's per-block execution time on
the *profiled* hardware model matches the measurement — the reference's
arithmetic: ``weight_bytes`` and ``act_bytes`` come from the tensors'
shapes and dtypes, ``flops`` from the clock (``seconds * hw.peak_flops``).

On CUDA a block is timed with ``torch.cuda.Event`` pairs around each warmed
call; on the CPU with ``time.perf_counter``.  The median of the timed calls
is kept.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

from repro_torch._device import tree_leaves
from repro_torch.core.types import BlockCost, HardwareModel


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensors of a params tree (or of one tensor)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _time_block(fn: Callable, params: Any, x: torch.Tensor,
                warmup: int = 2, iters: int = 5) -> float:
    """Median seconds of one call of ``fn(params, x)`` after ``warmup``."""
    with torch.no_grad():
        for _ in range(warmup):
            fn(params, x)
        times = []
        if x.device.type == "cuda":
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(params, x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(params, x)
                times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_blocks(
    block_fns: Sequence[Callable],
    block_params: Sequence[Any],
    x0: torch.Tensor,
    hw: HardwareModel,
    batch_divisor: int = 1,
) -> List[BlockCost]:
    """Measure each block end to end and calibrate BlockCost entries.

    Args:
      block_fns: per-depth apply functions (chained: block d feeds d+1).
      block_params: parameters for one representative node per depth.
      x0: input batch for depth 0, on the device the blocks run on.
      hw: the hardware model the calibrated costs should reproduce the
        measured seconds on (``hw.exec_seconds(flops) == measured``).
      batch_divisor: divide measured time by this to get per-sample cost.

    Returns:
      per-depth :class:`BlockCost` with measured-calibrated ``flops`` and
      exact ``weight_bytes``/``act_bytes``.
    """
    costs: List[BlockCost] = []
    h = x0
    for fn, params in zip(block_fns, block_params):
        seconds = _time_block(fn, params, h) / batch_divisor
        with torch.no_grad():
            out = fn(params, h)
        costs.append(
            BlockCost(
                weight_bytes=float(tree_bytes(params)),
                # Calibrated so hw.exec_seconds(flops) == measured seconds.
                flops=float(seconds * hw.peak_flops),
                act_bytes=float(tree_bytes(out)) / max(x0.shape[0], 1),
            )
        )
        h = out
    return costs


def profile_program_blocks(program, x0: torch.Tensor, hw: HardwareModel) -> List[BlockCost]:
    """Profile a MultitaskProgram's common architecture (one node per depth)."""
    graph = program.graph
    reps = [program.node_params[graph.path(0)[d]] for d in range(graph.depth)]
    return profile_blocks(
        program.block_fns, reps, x0, hw, batch_divisor=x0.shape[0]
    )
