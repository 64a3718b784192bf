"""Core datatypes shared across the Antler framework (PyTorch port).

A framework-free copy of ``repro.core.types``, kept equal to it.  Every
cost the planner and the executor's counters produce is expressed through
:class:`HardwareModel` as *modelled* seconds from three roofline terms
(compute / memory / interconnect); the presets are the paper's MCUs and the
reference's TPU constants.  None of them is a measurement of the GPU the
port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# A task-graph block node: (depth, group of tasks sharing it).  The executor
# and the cost model both key residency by these.
NodeId = Tuple[int, Tuple[int, ...]]
# Per-depth resident block (None = slot empty): what
# TaskGraphExecutor.residency_state() returns and what
# GraphCostModel.predicted_stats accepts as ``resume``.
Residency = Sequence[Optional[NodeId]]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Roofline constants of the execution platform.

    Attributes:
      name: human-readable platform name.
      peak_flops: peak FLOP/s per chip (bf16 for TPU targets).
      mem_bw: main-memory (HBM / FRAM / flash) bandwidth in bytes/s.
      link_bw: inter-chip link bandwidth in bytes/s (0 for single-chip MCUs).
      weight_load_bw: bandwidth for streaming weights from the *slow* tier
        (flash->SRAM on the MCU, host->HBM or HBM->VMEM on TPU).  This is the
        bandwidth that gives task switching its cost in the paper.
      joules_per_flop / joules_per_byte: optional energy model terms; the
        paper reports energy as well as time, so the benchmarks derive energy
        from the same counters.
    """

    name: str
    peak_flops: float
    mem_bw: float
    link_bw: float = 0.0
    weight_load_bw: Optional[float] = None
    joules_per_flop: float = 0.0
    joules_per_byte: float = 0.0

    @property
    def load_bw(self) -> float:
        return self.weight_load_bw if self.weight_load_bw is not None else self.mem_bw

    def exec_seconds(self, flops: float, bytes_touched: float = 0.0) -> float:
        """Roofline execution time of a block: max(compute, memory) term."""
        t_compute = flops / self.peak_flops if self.peak_flops else 0.0
        t_memory = bytes_touched / self.mem_bw if self.mem_bw else 0.0
        return max(t_compute, t_memory)

    def load_seconds(self, weight_bytes: float) -> float:
        """Time to bring a block's weights into the fast tier."""
        return weight_bytes / self.load_bw if self.load_bw else 0.0

    def link_seconds(self, collective_bytes: float) -> float:
        """Time the inter-chip collectives of a sharded program take."""
        return collective_bytes / self.link_bw if self.link_bw else 0.0

    def energy_joules(self, flops: float, bytes_moved: float) -> float:
        return flops * self.joules_per_flop + bytes_moved * self.joules_per_byte


# TPU v5e constants given in the brief: 197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s/link ICI.
TPU_V5E = HardwareModel(
    name="tpu-v5e",
    peak_flops=197e12,
    mem_bw=819e9,
    link_bw=50e9,
    # Weight swaps for cold task-graph branches come over PCIe/host DMA; a
    # conservative 10 GB/s models the "slow tier" that drives switching cost.
    weight_load_bw=10e9,
    # Rough public numbers for deriving an energy-style metric (J/op, J/byte).
    joules_per_flop=1.0e-12,
    joules_per_byte=60e-12,
)

# MCU-like platforms used by the paper-scale benchmarks so that the
# reproduction ratios (2.3x-4.6x etc.) are measured on comparable terms.
MSP430 = HardwareModel(
    name="msp430fr5994",
    peak_flops=2e6,          # ~16 MHz 16-bit MAC-per-8-cycles class
    mem_bw=8e6,              # SRAM
    link_bw=0.0,
    weight_load_bw=1e6,      # external FRAM streaming
    joules_per_flop=250e-12,
    joules_per_byte=120e-12,
)

STM32H747 = HardwareModel(
    name="stm32h747",
    peak_flops=2e8,          # ~480 MHz M7 w/ DSP MACs
    mem_bw=6.4e8,
    link_bw=0.0,
    weight_load_bw=1e8,      # eFlash read (~100 MB/s; the paper's Fig. 11
                             # shows near-invisible reload overhead on H747)
    joules_per_flop=30e-12,
    joules_per_byte=15e-12,
)


@dataclasses.dataclass(frozen=True)
class BlockCost:
    """Cost of one task-graph block.

    ``weight_bytes`` drives switching cost (the load part); ``flops`` and
    ``act_bytes`` drive the execute part.  All are *per single input*.
    """

    weight_bytes: float
    flops: float
    act_bytes: float = 0.0

    def exec_seconds(self, hw: HardwareModel) -> float:
        return hw.exec_seconds(self.flops, self.act_bytes + self.weight_bytes)

    def load_seconds(self, hw: HardwareModel) -> float:
        return hw.load_seconds(self.weight_bytes)

    def total_seconds(self, hw: HardwareModel) -> float:
        return self.exec_seconds(hw) + self.load_seconds(hw)

    def energy_joules(self, hw: HardwareModel) -> float:
        return hw.energy_joules(self.flops, 2.0 * self.weight_bytes + self.act_bytes)


@dataclasses.dataclass
class ExecutionStats:
    """Counters produced by the task-graph executor.

    These are the executor-side ground truth that the cost model predicts;
    tests assert the two agree.

    The ``*_collective_bytes`` counters are the per-kind inter-chip traffic
    of mesh-sharded execution, calibrated per fused-suffix dispatch from the
    lowered HLO in the reference; they stay zero on single-device engines
    (the only kind the port has so far).  Flat floats (not a dict) so
    ``dataclasses.replace`` copies — handed to every response in a group —
    never share mutable state.
    """

    blocks_executed: int = 0
    blocks_skipped: int = 0
    weight_bytes_loaded: float = 0.0
    weight_bytes_skipped: float = 0.0
    flops_executed: float = 0.0
    flops_skipped: float = 0.0
    tasks_run: int = 0
    tasks_skipped: int = 0
    all_gather_bytes: float = 0.0
    all_reduce_bytes: float = 0.0
    reduce_scatter_bytes: float = 0.0
    other_collective_bytes: float = 0.0
    # Weight-streaming counters (``core.executor.WeightStreamer``): bytes of
    # ``weight_bytes_loaded`` that arrived via an asynchronous prefetch
    # overlapped with the previous group's compute, and the residual stall
    # (modelled seconds) where the prefetch outran its overlap window.  Both
    # stay zero on engines without ``EnginePolicy.streaming``.
    prefetched_bytes: float = 0.0
    stream_stall_seconds: float = 0.0
    # Intermittent-execution counters: bytes of mid-suffix activation
    # checkpoints written to the durable tier (FRAM on the paper's MSP430)
    # and the modelled seconds those writes took.  Placement is chosen by
    # ``GraphCostModel.plan_checkpoints`` (checkpoint only when the expected
    # re-execution cost exceeds the write cost), so both sides of the
    # ``session.stats == session.predicted`` invariant add identical terms.
    # Zero on engines without a journal.
    checkpoint_bytes: float = 0.0
    checkpoint_seconds: float = 0.0
    # Input-adaptive gating counters (reference ``repro.adaptive``): per-(block, row)
    # fire/skip tallies of confidence-gated fused suffixes and the modelled
    # FLOPs the gated-off rows saved.  ``flops_executed`` counts only the
    # rows that actually fired, so modelled time/energy reflect the gating;
    # ``flops_gated`` is the remainder vs the all-blocks floor.  Floats (not
    # ints) because *expected* predictions under a ``GateModel`` are
    # fractional; realized counters are whole numbers of the same fields, so
    # realized-vs-predicted equality still compares exactly.  Zero on
    # engines without an ``AdaptivePolicy``.
    block_rows_fired: float = 0.0
    block_rows_gated: float = 0.0
    flops_gated: float = 0.0

    @property
    def collective_bytes(self) -> float:
        """Total inter-chip bytes across every collective kind."""
        return (
            self.all_gather_bytes
            + self.all_reduce_bytes
            + self.reduce_scatter_bytes
            + self.other_collective_bytes
        )

    def add_collectives(self, breakdown: "dict[str, float]") -> None:
        """Fold one dispatch's per-kind collective bytes (HLO kind names,
        as the reference's ``launch/hlo_cost.py::collective_breakdown`` names them)."""
        for kind, nbytes in breakdown.items():
            if kind == "all-gather":
                self.all_gather_bytes += nbytes
            elif kind == "all-reduce":
                self.all_reduce_bytes += nbytes
            elif kind == "reduce-scatter":
                self.reduce_scatter_bytes += nbytes
            else:
                self.other_collective_bytes += nbytes

    def compute_seconds(self, hw: HardwareModel) -> float:
        """Modelled compute + interconnect seconds (no weight-load term).

        This is the window an overlapped weight stream can hide behind: the
        prefetcher for group ``k+1`` runs while group ``k``'s fused suffix
        executes, so this group's compute window bounds how many of the next
        group's load bytes come for free.
        """
        return (
            hw.exec_seconds(self.flops_executed)
            + hw.link_seconds(self.collective_bytes)
        )

    def seconds(self, hw: HardwareModel, weight_shards: int = 1) -> float:
        """Modelled wall-clock of these counters on ``hw``.

        ``weight_shards`` is how many ways the weights are sharded over the
        mesh (``ShardingPolicy.weight_shards``): each chip streams only its
        ``1/weight_shards`` slice, so the load term divides while the
        (per-chip) collective traffic adds a link term.

        With streaming, ``prefetched_bytes`` of the loads were overlapped
        with earlier compute and drop out of the synchronous load term; what
        could not be hidden is already accounted as ``stream_stall_seconds``
        — i.e. per group the modelled time is
        ``max(compute, overlapped_load) + sync_load`` expressed as
        ``compute + stall + sync_load``.
        """
        sync_bytes = max(self.weight_bytes_loaded - self.prefetched_bytes, 0.0)
        return (
            self.compute_seconds(hw)
            + hw.load_seconds(sync_bytes / max(weight_shards, 1))
            + self.stream_stall_seconds
            + self.checkpoint_seconds
        )

    def energy(self, hw: HardwareModel) -> float:
        return hw.energy_joules(
            self.flops_executed,
            2.0 * self.weight_bytes_loaded + self.checkpoint_bytes,
        )

    def compute_energy(self, hw: HardwareModel) -> float:
        """Joules of the compute term alone (no loads, no checkpoints).

        This is the energy a power failure can waste: weight residency and
        checkpoints live in the durable tier and survive a crash, but any
        compute since the last durable point must be re-executed on the next
        charge cycle.  The intermittent benchmark's re-execution gate
        compares this term across recovery strategies.
        """
        return hw.energy_joules(self.flops_executed, 0.0)

    def merge(self, other: "ExecutionStats") -> "ExecutionStats":
        return ExecutionStats(
            blocks_executed=self.blocks_executed + other.blocks_executed,
            blocks_skipped=self.blocks_skipped + other.blocks_skipped,
            weight_bytes_loaded=self.weight_bytes_loaded + other.weight_bytes_loaded,
            weight_bytes_skipped=self.weight_bytes_skipped + other.weight_bytes_skipped,
            flops_executed=self.flops_executed + other.flops_executed,
            flops_skipped=self.flops_skipped + other.flops_skipped,
            tasks_run=self.tasks_run + other.tasks_run,
            tasks_skipped=self.tasks_skipped + other.tasks_skipped,
            all_gather_bytes=self.all_gather_bytes + other.all_gather_bytes,
            all_reduce_bytes=self.all_reduce_bytes + other.all_reduce_bytes,
            reduce_scatter_bytes=(
                self.reduce_scatter_bytes + other.reduce_scatter_bytes
            ),
            other_collective_bytes=(
                self.other_collective_bytes + other.other_collective_bytes
            ),
            prefetched_bytes=self.prefetched_bytes + other.prefetched_bytes,
            stream_stall_seconds=(
                self.stream_stall_seconds + other.stream_stall_seconds
            ),
            checkpoint_bytes=self.checkpoint_bytes + other.checkpoint_bytes,
            checkpoint_seconds=(
                self.checkpoint_seconds + other.checkpoint_seconds
            ),
            block_rows_fired=self.block_rows_fired + other.block_rows_fired,
            block_rows_gated=self.block_rows_gated + other.block_rows_gated,
            flops_gated=self.flops_gated + other.flops_gated,
        )


@dataclasses.dataclass(frozen=True)
class TaskGateRecord:
    """One task's realized gate outcome inside a group's execution.

    The executor emits one record per task in the group's effective order
    (``TaskGraphExecutor.last_trace``); the cost model replays the same
    records (``GraphCostModel.predicted_stats(..., gate_trace=...)``) so the
    realized-conditional prediction stays field-exact under gating.

    Attributes:
      task: task id.
      weight: rows of the batch this task ran for (0 = the task's legacy
        ``gate=`` callback skipped it for the whole group — the executor
        never dispatched it, so replay must not advance residency or the
        activation cache past it).
      fired: per executed block depth (``resume`` .. ``depth-1``), how many
        of the ``weight`` rows the adaptive gate let through.  ``None``
        means no adaptive gater: every executed block fired for all rows.
      resume: the activation-resume depth the executor actually used, when
        the emitter knows it (cross-checked against the replay walk).
      offered: rows of the batch the task was *offered* (the group's valid
        count) before any legacy gate — what ``GateModelCalibrator`` uses
        as the denominator of the task fire probability.
    """

    task: int
    weight: int
    fired: Optional[Tuple[int, ...]] = None
    resume: Optional[int] = None
    offered: Optional[int] = None
