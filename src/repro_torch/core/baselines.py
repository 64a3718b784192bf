"""Baseline multitask-inference systems the paper compares against (§6.1),
the PyTorch port of ``repro.core.baselines`` (pure cost-model arithmetic).

* **Vanilla** — independently trained classifiers executed sequentially:
  every task loads and executes its full network (implemented as a real
  executor in :mod:`repro_torch.core.executor`; here we expose its cost model).
* **NWV** (Neural Weight Virtualization, Lee & Nirjon 2020) — all tasks
  packed *in RAM* by virtualizing weight pages across tasks: zero switching
  (weight-load) overhead, but every task still executes its full network
  (no activation reuse), and accuracy degrades as the number of packed tasks
  grows.
* **NWS** (Weight Separation, Lee & Nirjon 2022) — like NWV but a small
  fraction (~7% in the paper) of high-significance weights lives in external
  storage and is reloaded per task switch.
* **YONO** (Kwon et al. 2022) — compressed in-memory packing (product
  quantization); zero switching cost, full re-execution, in-RAM footprint.

All four reuse the same per-depth :class:`BlockCost` table as Antler so that
time/energy/memory comparisons are apples-to-apples; the structural facts
(what is loaded, what is re-executed, what fits in RAM) come from each
paper's design.  The executor-level Vanilla baseline cross-checks the
analytic model.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.cost_model import GraphCostModel
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import BlockCost, ExecutionStats, HardwareModel


@dataclasses.dataclass(frozen=True)
class BaselineReport:
    name: str
    seconds: float
    joules: float
    memory_bytes: float        # total storage footprint of all tasks
    ram_resident_bytes: float  # portion that must sit in RAM


def _full_exec(block_costs: Sequence[BlockCost], hw: HardwareModel) -> float:
    return sum(hw.exec_seconds(bc.flops, bc.act_bytes) for bc in block_costs)


def _full_exec_energy(block_costs: Sequence[BlockCost], hw: HardwareModel) -> float:
    return sum(hw.energy_joules(bc.flops, bc.act_bytes) for bc in block_costs)


def _full_load(block_costs: Sequence[BlockCost], hw: HardwareModel) -> float:
    return sum(hw.load_seconds(bc.weight_bytes) for bc in block_costs)


def _weights(block_costs: Sequence[BlockCost]) -> float:
    return sum(bc.weight_bytes for bc in block_costs)


def vanilla_baseline(
    num_tasks: int, block_costs: Sequence[BlockCost], hw: HardwareModel
) -> BaselineReport:
    """Every task: full weight load from slow tier + full execution."""
    t = num_tasks * (_full_exec(block_costs, hw) + _full_load(block_costs, hw))
    e = num_tasks * (
        _full_exec_energy(block_costs, hw)
        + hw.energy_joules(0.0, 2.0 * _weights(block_costs))
    )
    mem = num_tasks * _weights(block_costs)
    return BaselineReport("vanilla", t, e, mem, _weights(block_costs))


def nwv_baseline(
    num_tasks: int, block_costs: Sequence[BlockCost], hw: HardwareModel
) -> BaselineReport:
    """NWV: all-in-RAM virtualized weights; zero switching, full re-exec.

    Weight pages are shared across tasks, so storage ~= one network (plus
    per-task page tables, which we fold into a 10% overhead as the paper's
    measured footprints suggest).
    """
    t = num_tasks * _full_exec(block_costs, hw)
    e = num_tasks * _full_exec_energy(block_costs, hw)
    mem = 1.10 * _weights(block_costs)
    return BaselineReport("nwv", t, e, mem, mem)


def nws_baseline(
    num_tasks: int,
    block_costs: Sequence[BlockCost],
    hw: HardwareModel,
    external_fraction: float = 0.07,
) -> BaselineReport:
    """NWS: NWV + ~7% high-significance weights streamed from storage."""
    per_switch_load = hw.load_seconds(external_fraction * _weights(block_costs))
    t = num_tasks * (_full_exec(block_costs, hw) + per_switch_load)
    e = num_tasks * (
        _full_exec_energy(block_costs, hw)
        + hw.energy_joules(0.0, 2.0 * external_fraction * _weights(block_costs))
    )
    # Shared virtualized core + per-task external residue.
    mem = 1.10 * _weights(block_costs) + num_tasks * external_fraction * _weights(
        block_costs
    )
    return BaselineReport("nws", t, e, mem, 1.10 * _weights(block_costs))


def yono_baseline(
    num_tasks: int,
    block_costs: Sequence[BlockCost],
    hw: HardwareModel,
    compression: float = 0.12,
) -> BaselineReport:
    """YONO: PQ-compressed in-memory packing; decode adds a small exec tax."""
    decode_tax = 1.05  # codebook lookup overhead on top of raw execution
    t = num_tasks * decode_tax * _full_exec(block_costs, hw)
    e = num_tasks * decode_tax * _full_exec_energy(block_costs, hw)
    mem = max(compression * num_tasks, 1.0) * _weights(block_costs) * 0.85
    return BaselineReport("yono", t, e, mem, mem)


def antler_report(
    graph: TaskGraph,
    block_costs: Sequence[BlockCost],
    hw: HardwareModel,
    order: Sequence[int],
) -> BaselineReport:
    """Antler's own numbers from the predicted executor counters."""
    cm = GraphCostModel(graph, block_costs, hw)
    stats: ExecutionStats = cm.predicted_stats(order)
    return BaselineReport(
        "antler",
        stats.seconds(hw),
        stats.energy(hw),
        cm.storage_bytes(),
        _weights(block_costs),  # static buffer = one common network
    )
