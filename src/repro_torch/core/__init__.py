"""Antler core: task affinity, task graphs, ordering, and the block-cached
multitask executor (PyTorch port)."""

from repro_torch.core.affinity import (
    affinity_matrix,
    compute_affinity,
    pairwise_pearson_dissimilarity,
    profile_task,
    spearman,
)
from repro_torch.core.constraints import Constraints, no_constraints
from repro_torch.core.cost_model import GraphCostModel
from repro_torch.core.executor import (
    MultitaskProgram,
    TaskGraphExecutor,
    VanillaExecutor,
    run_in_order,
)
from repro_torch.core.genetic import GAConfig, genetic_order
from repro_torch.core.ordering import (
    ILPFormulation,
    OrderingResult,
    branch_and_bound_order,
    brute_force_order,
    fitness,
    greedy_2opt_order,
    held_karp_order,
    optimal_order,
    solve_suborder,
)
from repro_torch.core.task_graph import (
    TaskGraph,
    enumerate_task_graphs,
    variety_score,
)
from repro_torch.core.tradeoff import (
    GraphCandidate,
    TradeoffResult,
    select_task_graph,
    tradeoff_curve,
)
from repro_torch.core.types import (
    MSP430,
    STM32H747,
    TPU_V5E,
    BlockCost,
    ExecutionStats,
    HardwareModel,
    TaskGateRecord,
)

__all__ = [k for k in dir() if not k.startswith("_")]
