"""Request-group serving of multitask programs."""
from repro_torch.serving.batching import (
    DEFAULT_BATCH_SHAPES,
    RequestGroup,
    RequestGroupScheduler,
    effective_order,
    normalize_subset,
    order_groups,
)
from repro_torch.serving.engine import (
    GroupExecution,
    MultitaskEngine,
    MultitaskRequest,
    MultitaskResponse,
)
from repro_torch.serving.policies import EnginePolicy
