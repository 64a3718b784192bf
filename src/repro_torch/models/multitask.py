"""Task-graph-branched multitask models, the PyTorch port of
``repro.models.multitask`` (the CNN program).

Binds a :class:`~repro_torch.core.task_graph.TaskGraph` to the LeNet-5
blocks and parameters:

* :func:`build_cnn_program` — random weights from a ``torch.Generator``;
* :func:`program_from_reference` — the JAX program's own weights, carried
  over as numpy arrays, so the port and the reference compute the same
  function;
* :func:`multitask_forward` — the uncached forward of every task.

The transformer programs and joint training wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.executor import MultitaskProgram
from repro_torch.core.task_graph import TaskGraph
from repro_torch.models import cnn

Params = Dict[str, Any]
NodeId = Tuple[int, Tuple[int, ...]]


def _cnn_program(
    graph: TaskGraph,
    node_params: Dict[NodeId, Params],
    head_params: List[Params],
    input_hw: Tuple[int, int, int],
) -> MultitaskProgram:
    _inits, applies, costs, _feat = cnn.build_lenet5_blocks(input_hw)
    if graph.depth != len(applies):
        raise ValueError(
            f"graph depth {graph.depth} != number of CNN blocks {len(applies)}"
        )
    return MultitaskProgram(
        graph=graph,
        block_fns=applies,
        node_params=node_params,
        head_fns=[cnn.head_apply] * graph.num_tasks,
        head_params=head_params,
        block_costs=costs,
    )


def build_cnn_program(
    graph: TaskGraph,
    num_classes: Sequence[int],
    input_hw: Tuple[int, int, int] = (28, 28, 1),
    *,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> MultitaskProgram:
    """Instantiate per-node CNN blocks + per-task heads for a task graph.

    Weights are drawn from ``generator`` (in node order, then heads) and
    placed on ``device`` — ``cuda`` unless the caller names another.
    """
    dev = resolve_device(device)
    inits, _applies, _costs, feat = cnn.build_lenet5_blocks(input_hw)
    if graph.depth != len(inits):
        raise ValueError(
            f"graph depth {graph.depth} != number of CNN blocks {len(inits)}"
        )
    node_params = {
        node: inits[node[0]](generator, dev) for node in graph.nodes()
    }
    head_params = [
        cnn.head_init(generator, feat, num_classes[t], dev)
        for t in range(graph.num_tasks)
    ]
    return _cnn_program(graph, node_params, head_params, input_hw)


def program_from_reference(
    graph: TaskGraph,
    node_params: Mapping[NodeId, Mapping[str, np.ndarray]],
    head_params: Sequence[Mapping[str, np.ndarray]],
    input_hw: Tuple[int, int, int] = (28, 28, 1),
    *,
    device: DeviceLike = None,
) -> MultitaskProgram:
    """The port's CNN program with the JAX program's weights.

    ``node_params`` maps ``(depth, group)`` to ``{"w", "b"}`` numpy arrays
    and ``head_params`` lists each task's ``{"w", "b"}``, exactly as the
    reference's ``build_cnn_program`` lays them out.  The port keeps the
    reference's layouts (HWIO convs, ``x @ w`` dense), so the arrays carry
    over unchanged.
    """
    dev = resolve_device(device)

    def convert(p: Mapping[str, np.ndarray]) -> Params:
        return {
            k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in p.items()
        }

    nodes = {node: convert(node_params[node]) for node in graph.nodes()}
    heads = [convert(p) for p in head_params]
    return _cnn_program(graph, nodes, heads, input_hw)


def program_trainable_params(program: MultitaskProgram) -> Params:
    """Flat params: {"nodes": {repr(node): ...}, "heads": [...]}, the
    reference's layout."""
    return {
        "nodes": {repr(k): v for k, v in program.node_params.items()},
        "heads": list(program.head_params),
    }


def multitask_forward(
    program: MultitaskProgram, flat: Params, x: torch.Tensor
) -> List[torch.Tensor]:
    """Uncached forward of every task (no residency or activation cache).

    Shared nodes appear once in ``flat`` and each is computed once per call
    (memoised by node), as in the reference.
    """
    graph = program.graph
    outs = []
    memo: Dict[str, torch.Tensor] = {}
    for t in range(graph.num_tasks):
        h = x
        for d, node in enumerate(graph.path(t)):
            k = repr(node)
            if k in memo:
                h = memo[k]
                continue
            h = program.block_fns[d](flat["nodes"][k], h)
            memo[k] = h
        outs.append(program.head_fns[t](flat["heads"][t], h))
    return outs
