"""Confidence-based block gating for fused-suffix execution (the PyTorch
port of ``repro.adaptive.gating``).

A :class:`BlockGater` attaches a pure confidence function to the
executor's suffix programs; each shape-preserving block then keeps its
output only for the batch rows whose confidence is still *below* the
threshold (low confidence = keep refining, high confidence = the
representation is already decisive and the row can stop paying).

Two modes:

* ``"early_exit"`` — once a row's confidence clears the threshold it skips
  every remaining block of the suffix (the row has *exited*).
* ``"per_block"`` — each block re-evaluates the gate independently; a row
  can skip one block and fire a later one.

For shape-preserving passthrough gating with a pure confidence function the
two coincide on homogeneous (scan-mode) suffixes: a skipped row's activation
is unchanged, so its confidence is unchanged, so it keeps skipping.  That
equivalence is what lets checkpoint segments and crash recovery re-derive
identical gate decisions without threading an alive mask across program
boundaries.

Gating is masked, as in the reference: every block runs for every row and
``torch.where`` keeps the old activation of the rows whose gate did not
fire.  The thresholds reach the suffix as a float32 tensor on the
activation's device (one per ``(resume, stop)``, refilled in place when
the threshold changes), so the decision never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

GATE_MODES = ("early_exit", "per_block")

# A threshold of +inf always fires: conf < inf for every finite confidence.
ALWAYS_FIRE = math.inf


def mean_abs_confidence(h: torch.Tensor) -> torch.Tensor:
    """Default confidence: mean absolute activation of one row.

    What ``jnp.mean(jnp.abs(h))`` computes: the sum accumulates in float32
    and the mean is rounded to ``h``'s dtype (a bf16 row gives a bf16
    confidence), which the executor then compares with the float32
    threshold in float32 — so fire decisions near the threshold match the
    reference's.
    """
    return h.abs().mean(dtype=torch.float32).to(h.dtype)


@dataclasses.dataclass
class BlockGater:
    """Per-block confidence gate the executor threads into fused suffixes.

    Attributes:
      confidence_fn: pure ``row -> scalar`` confidence; the executor applies
        it over the request axis with ``torch.vmap`` (the reference's
        ``jax.vmap``).
      mode: ``"early_exit"`` or ``"per_block"`` (see module docstring).
      threshold: fire a block for a row iff ``confidence < threshold``;
        ``math.inf`` (the default) fires everything — the all-blocks floor.
        Mutable on purpose: the serving session retunes it per group from
        the :class:`~repro_torch.adaptive.policy.AdaptivePolicy` deadline
        ladder; no suffix program is rebuilt for it.
      min_blocks: blocks ``0 .. min_blocks-1`` of every path always fire
        (their per-depth threshold is ``inf``), bounding how early a row
        may exit regardless of threshold.
    """

    confidence_fn: Callable = mean_abs_confidence
    mode: str = "early_exit"
    threshold: float = ALWAYS_FIRE
    min_blocks: int = 1

    def __post_init__(self) -> None:
        if self.mode not in GATE_MODES:
            raise ValueError(f"unknown gate mode {self.mode!r}")
        if self.min_blocks < 0:
            raise ValueError("min_blocks must be >= 0")

    def suffix_thresholds(self, resume: int, depth: int) -> Tuple[float, ...]:
        """Per-depth thresholds for a suffix resuming at ``resume``.

        Depths below ``min_blocks`` get ``inf`` (always fire); the rest get
        the current ``threshold``.  The executor keeps them on the device as
        the float32 tensor the suffix compares against.
        """
        return tuple(
            ALWAYS_FIRE if d < self.min_blocks else float(self.threshold)
            for d in range(resume, depth)
        )
