"""Serving-facing knob for input-adaptive execution (the PyTorch port of
``repro.adaptive.policy``, kept equal to it).

``EnginePolicy.adaptive`` carries one of these; the engine builds the
executor's :class:`~repro_torch.adaptive.gating.BlockGater` from it, seeds the
cost model's :class:`~repro_torch.adaptive.gate_model.GateModel`, and the session
walks the deadline ladder each group to pick the confidence threshold.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

from repro_torch.adaptive.gate_model import GateModel
from repro_torch.adaptive.gating import GATE_MODES, mean_abs_confidence


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """Input-adaptive serving configuration.

    Attributes:
      threshold: base confidence threshold (fire a block for a row iff
        ``confidence < threshold``); ``math.inf`` = all-blocks floor.
      mode: ``"early_exit"`` or ``"per_block"``.
      min_blocks: per-path block count every row always pays.
      confidence: pure per-row confidence function (a torch function of one
        row, applied over the request axis with ``torch.vmap``).
      gate_model: expected fire/task probabilities for the cost model and
        order solvers; ``None`` predicts the all-blocks floor until
        calibrated.
      ladder: accuracy ladder ``((min_slack_seconds, threshold), ...)`` —
        per group the session picks the threshold of the *tightest* rung
        whose ``min_slack`` the group's worst deadline slack still clears
        (rungs sorted by ``min_slack``; more slack -> a tighter, i.e.
        lower, threshold -> more exits -> cheaper but approximate).  Groups
        with no slack (or no ladder) use the base ``threshold``.
      calibrate_online: refresh ``gate_model`` from live realized traces
        after every group, so expected-cost planning tracks traffic drift.
    """

    threshold: float = math.inf
    mode: str = "early_exit"
    min_blocks: int = 1
    confidence: Callable = mean_abs_confidence
    gate_model: Optional[GateModel] = None
    ladder: Tuple[Tuple[float, float], ...] = ()
    calibrate_online: bool = False

    def __post_init__(self) -> None:
        if self.mode not in GATE_MODES:
            raise ValueError(f"unknown gate mode {self.mode!r}")

    def threshold_for_slack(self, slack: Optional[float]) -> float:
        """Ladder lookup: the threshold earned by ``slack`` deadline room.

        ``slack`` is the group's minimum remaining deadline slack in
        seconds (``None`` = no deadlines in the group -> base threshold).
        """
        if slack is None or not self.ladder:
            return float(self.threshold)
        best = float(self.threshold)
        best_rung = -math.inf
        for min_slack, thr in self.ladder:
            if slack >= min_slack and min_slack > best_rung:
                best_rung = min_slack
                best = float(thr)
        return best
