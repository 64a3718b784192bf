"""Input-adaptive execution: confidence gating, gate models, policy (the
PyTorch port of ``repro.adaptive``).

The executor consumes a :class:`BlockGater`, the cost model a
:class:`GateModel`, and the serving stack an :class:`AdaptivePolicy` that
binds the two plus the deadline threshold ladder.
"""
from repro_torch.adaptive.gate_model import GateModel, GateModelCalibrator
from repro_torch.adaptive.gating import (
    ALWAYS_FIRE, GATE_MODES, BlockGater, mean_abs_confidence,
)
from repro_torch.adaptive.policy import AdaptivePolicy

__all__ = [
    "ALWAYS_FIRE",
    "GATE_MODES",
    "AdaptivePolicy",
    "BlockGater",
    "GateModel",
    "GateModelCalibrator",
    "mean_abs_confidence",
]
