"""Serving: the Antler multitask engine, session-based admission, and the
batched LM prefill/decode path (PyTorch port of ``repro.serving``).

The task-graph surface is session-first: open a ``ServingSession`` on a
``MultitaskEngine`` (``engine.session()``), ``submit()`` requests over time
under a pluggable ``SchedulingPolicy``, and resolve ``MultitaskFuture``s.
``serve`` / ``serve_batch`` remain as one-shot wrappers over the same
machinery; ``serve_many`` is deprecated.  Reliability lives in
``repro_torch.serving.reliability``, the write-ahead journal of
intermittent-power serving in ``repro_torch.serving.journal``, and
``ContinuousBatcher`` serves LM generation requests in waves.
"""
from repro_torch.serving.batching import (
    DEFAULT_BATCH_SHAPES, ContinuousBatcher, GenRequest, GenResult,
    RequestGroup, RequestGroupScheduler, effective_order, normalize_subset,
    order_groups,
)
from repro_torch.serving.engine import (
    GroupExecution, IntermittentContext, LMServer, MultitaskEngine,
    MultitaskRequest, MultitaskResponse,
)
from repro_torch.serving.journal import (
    FileJournalStore, Journal, JournalState, JournalStore, MemoryJournalStore,
)
from repro_torch.serving.policies import (
    AffinityPolicy, EnginePolicy, GreedyBatchPolicy, SchedulingPolicy,
    SloAwarePolicy, WindowPolicy,
)
from repro_torch.serving.reliability import (
    FAULT_SITES, POWER_SITES, DeadlineExceeded, EnergyBudget, FaultInjector,
    InjectedFault, PowerFailure, PowerFailureInjector, QueueFull,
    RequestError, RetryPolicy, TenantStats,
)
from repro_torch.serving.session import (
    AdmissionQueue, MultitaskFuture, PendingRequest, ServingSession,
)

__all__ = [
    # engine + request/response surface
    "MultitaskEngine",
    "MultitaskRequest",
    "MultitaskResponse",
    "GroupExecution",
    "IntermittentContext",
    # sessions
    "ServingSession",
    "MultitaskFuture",
    "AdmissionQueue",
    "PendingRequest",
    # policies
    "EnginePolicy",
    "SchedulingPolicy",
    "GreedyBatchPolicy",
    "WindowPolicy",
    "AffinityPolicy",
    "SloAwarePolicy",
    # reliability
    "RequestError",
    "DeadlineExceeded",
    "QueueFull",
    "InjectedFault",
    "RetryPolicy",
    "FaultInjector",
    "TenantStats",
    "FAULT_SITES",
    # intermittent power
    "PowerFailure",
    "PowerFailureInjector",
    "POWER_SITES",
    "EnergyBudget",
    "Journal",
    "JournalState",
    "JournalStore",
    "MemoryJournalStore",
    "FileJournalStore",
    # request grouping
    "DEFAULT_BATCH_SHAPES",
    "RequestGroup",
    "RequestGroupScheduler",
    "effective_order",
    "normalize_subset",
    "order_groups",
    # LM serving path
    "LMServer",
    "ContinuousBatcher",
    "GenRequest",
    "GenResult",
]
