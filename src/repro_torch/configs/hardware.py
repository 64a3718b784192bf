"""Named hardware presets for the paper's MCU deployment targets, the
PyTorch port of ``repro.configs.hardware`` (the same three presets).

The paper (Antler, arXiv:2302.13155) evaluates on two boards; the
benchmarks select them by name through :func:`get_hardware` so the
paper-scale sweeps and the intermittent-power benchmark state their
platform explicitly instead of importing loose constants.

* **msp430fr5994** — TI MSP430FR5994 (the batteryless/intermittent
  flagship): 16 MHz 16-bit MCU, 8 KB SRAM + 256 KB on-chip FRAM, external
  FRAM for weights.  The paper's Table 4/5 energy/latency numbers and the
  intermittent traces come from this board: ~2 MFLOP/s effective MAC
  throughput (MAC-per-8-cycles class), ~8 MB/s SRAM, ~1 MB/s external-FRAM
  weight streaming, ~250 pJ/op and ~120 pJ/byte — the FRAM write-per-byte
  cost is what makes checkpoint placement a real trade
  (``GraphCostModel.plan_checkpoints``).
* **stm32h747** — ST STM32H747 (the high-end comparison): 480 MHz
  Cortex-M7 + 240 MHz M4, ~200 MFLOP/s with DSP MACs, 640 KB SRAM,
  ~100 MB/s eFlash reads — the paper's Fig. 11 shows near-invisible
  weight-reload overhead here, which these constants reproduce.

Both presets are the canonical :data:`repro_torch.core.types.MSP430` /
:data:`repro_torch.core.types.STM32H747` values re-exported under the registry;
``tpu-v5e`` is included so serving benchmarks can name their default
platform the same way.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.types import MSP430, STM32H747, TPU_V5E, HardwareModel

HARDWARE: Dict[str, HardwareModel] = {
    "msp430fr5994": MSP430,
    "stm32h747": STM32H747,
    "tpu-v5e": TPU_V5E,
}


def list_hardware() -> List[str]:
    return list(HARDWARE)


def get_hardware(name: str) -> HardwareModel:
    """Look up a named hardware preset (e.g. ``"msp430fr5994"``)."""
    key = name.strip().lower()
    if key not in HARDWARE:
        raise KeyError(
            f"unknown hardware {name!r}; known: {list_hardware()}"
        )
    return HARDWARE[key]
