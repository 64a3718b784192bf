"""Task-graph-branched multitask models, the PyTorch port of
``repro.models.multitask``.

Binds a :class:`~repro_torch.core.task_graph.TaskGraph` to concrete blocks
and parameters:

* :func:`build_cnn_program` — the paper-scale LeNet-5 blocks, random
  weights from a ``torch.Generator``;
* :func:`program_from_reference` — the JAX CNN program's own weights,
  carried over as numpy arrays, so the port and the reference compute the
  same function;
* :func:`build_transformer_program` — transformer backbones of the dense
  family: blocks are contiguous layer ranges, tasks are classifier heads on
  the last position's standardised hidden state (the reference's serving
  analogue), weights drawn on the generator's device;
* :func:`transformer_program_from_reference` /
  :func:`params_from_reference` — the JAX transformer program's and model's
  weights, carried over;
* :func:`multitask_forward` — the uncached forward of every task;
* :func:`program_trainable_params` / :func:`program_with_params` /
  :func:`multitask_loss` — the joint multitask training surface (gradients
  come from autograd; shared nodes appear once, so their gradients
  accumulate across the tasks that use them).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.executor import MultitaskProgram
from repro_torch.core.task_graph import TaskGraph
from repro_torch.core.types import BlockCost
from repro_torch.models import cnn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

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


# --------------------------------------------------------------------------
# Transformer program (the reference's serving analogue)
# --------------------------------------------------------------------------

def _split_layers(num_layers: int, num_blocks: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) layer ranges, near-equal sizes."""
    base, rem = divmod(num_layers, num_blocks)
    ranges, start = [], 0
    for i in range(num_blocks):
        n = base + (1 if i < rem else 0)
        ranges.append((start, start + n))
        start += n
    return ranges


def transformer_block_costs(
    cfg: ModelConfig, ranges: Sequence[Tuple[int, int]], seq_len: int
) -> List[BlockCost]:
    """Per-block weight bytes + FLOPs for a layer-range block (per sample).

    The same floats, in the same order, as the reference: the executor's
    counters are compared field for field.
    """
    bytes_per_param = cfg.params_dtype().itemsize
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    per_layer_params = (
        d * cfg.n_heads * hd          # wq
        + 2 * d * cfg.n_kv_heads * hd # wk, wv
        + cfg.n_heads * hd * d        # wo
        + (3 if cfg.activation == "swiglu" else 2) * d * f
        + 2 * d                       # norms
    )
    per_layer_flops = 2.0 * seq_len * (
        d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
        + (3 if cfg.activation == "swiglu" else 2) * d * f
    ) + 2.0 * 2.0 * seq_len * seq_len * cfg.n_heads * hd / 2.0  # causal attn
    out = []
    for (a, b) in ranges:
        n = b - a
        out.append(
            BlockCost(
                weight_bytes=float(bytes_per_param * per_layer_params * n),
                flops=float(per_layer_flops * n),
                act_bytes=float(2.0 * seq_len * d),
            )
        )
    return out


def _transformer_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear probe on the last position (which sees everything).

    Parameter-free standardisation first, with the population std (ddof 0,
    what ``jnp.std`` computes): the residual stream's scale grows with depth
    at init.
    """
    pooled = x[:, -1].float()
    pooled = (pooled - pooled.mean(-1, keepdim=True)) / (
        pooled.std(-1, keepdim=True, correction=0) + 1e-6
    )
    return pooled @ p["w"] + p["b"]


def _transformer_program(
    graph: TaskGraph,
    cfg: ModelConfig,
    node_params: Dict[NodeId, Params],
    head_params: List[Params],
    seq_len: int,
) -> MultitaskProgram:
    ranges = _split_layers(cfg.num_layers, graph.depth)

    def make_block_fn(depth: int):
        # One closure per depth, as in the reference: the executor sees
        # distinct block fns and drives every suffix "unrolled".
        def apply(p: Params, x: torch.Tensor) -> torch.Tensor:
            if depth == 0:
                x = L.embed_tokens(p["embed"], x.long(), cfg)
            q_pos = torch.arange(seq_len, dtype=torch.int32, device=x.device)
            for i in range(T.num_stacked(p["layers"])):
                x, _, _ = T._layer_apply(T.layer_params(p["layers"], i), x, cfg, q_pos)
            return x

        return apply

    return MultitaskProgram(
        graph=graph,
        block_fns=[make_block_fn(d) for d in range(graph.depth)],
        node_params=node_params,
        head_fns=[_transformer_head] * graph.num_tasks,
        head_params=head_params,
        block_costs=transformer_block_costs(cfg, ranges, seq_len),
    )


def build_transformer_program(
    graph: TaskGraph,
    cfg: ModelConfig,
    num_classes: Sequence[int],
    seq_len: int = 128,
    *,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> MultitaskProgram:
    """Blocks = contiguous transformer layer ranges; heads = linear probes.

    The depth-0 block also owns the embedding table (it is always the
    root-most shared computation).  Weights are drawn from ``generator`` on
    its own device (in node order, then heads) and placed on ``device`` —
    ``cuda`` unless the caller names another; pass a CUDA generator to draw
    full-width weights on the card.
    """
    dev = resolve_device(device)
    T._check_family(cfg)
    ranges = _split_layers(cfg.num_layers, graph.depth)

    def init_block(depth: int) -> Params:
        a, b = ranges[depth]
        p: Params = {"layers": T.init_layers(generator, cfg, b - a, dev)}
        if depth == 0:
            p["embed"] = L.init_embed(generator, cfg, dev)
        return p

    node_params = {node: init_block(node[0]) for node in graph.nodes()}
    head_params = []
    for t in range(graph.num_tasks):
        w = L.dense_init(generator, cfg.d_model, (num_classes[t],), torch.float32, dev)
        head_params.append({
            "w": w, "b": torch.zeros((num_classes[t],), dtype=torch.float32, device=dev),
        })
    return _transformer_program(graph, cfg, node_params, head_params, seq_len)


def _from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """A reference array as a tensor of the same dtype (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree_from_numpy(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return _from_numpy(tree, device)


def params_from_reference(
    cfg: ModelConfig, params: Mapping[str, Any], *, device: DeviceLike = None
) -> Params:
    """The reference's ``init`` tree (numpy leaves) of a dense, SSM or hybrid
    model, or of one of its modules, as the port's params: the same layouts
    — stacked layers, the hybrid's two-level (n_inv, period, ...) Mamba2
    stack and its optional ``inv_lora`` included — so it carries over leaf
    for leaf."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch runs the dense, "
            "ssm and hybrid families"
        )
    return _tree_from_numpy(params, resolve_device(device))


def transformer_program_from_reference(
    graph: TaskGraph,
    cfg: ModelConfig,
    node_params: Mapping[NodeId, Mapping[str, Any]],
    head_params: Sequence[Mapping[str, Any]],
    seq_len: int = 128,
    *,
    device: DeviceLike = None,
) -> MultitaskProgram:
    """The port's transformer program with the JAX program's weights.

    ``node_params`` maps ``(depth, group)`` to the reference's
    ``{"layers": ..., "embed": ...}`` trees of numpy arrays and
    ``head_params`` lists each task's ``{"w", "b"}``, as the reference's
    ``build_transformer_program`` lays them out.
    """
    dev = resolve_device(device)
    T._check_family(cfg)
    nodes = {node: _tree_from_numpy(node_params[node], dev) for node in graph.nodes()}
    heads = [_tree_from_numpy(p, dev) for p in head_params]
    return _transformer_program(graph, cfg, nodes, heads, seq_len)


def program_trainable_params(program: MultitaskProgram) -> Params:
    """Flat params: {"nodes": {repr(node): ...}, "heads": [...]}, the
    reference's layout."""
    return {
        "nodes": {repr(k): v for k, v in program.node_params.items()},
        "heads": list(program.head_params),
    }


def program_with_params(program: MultitaskProgram, flat: Params) -> MultitaskProgram:
    """``program`` with the parameters of ``flat`` (the layout
    :func:`program_trainable_params` returns), e.g. after training."""
    node_params = {k: flat["nodes"][repr(k)] for k in program.node_params}
    return MultitaskProgram(
        graph=program.graph,
        block_fns=program.block_fns,
        node_params=node_params,
        head_fns=program.head_fns,
        head_params=list(flat["heads"]),
        block_costs=program.block_costs,
    )


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


def multitask_loss(
    program: MultitaskProgram,
    flat: Params,
    x: torch.Tensor,
    labels: torch.Tensor,  # (num_tasks, B) integer labels
    task_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean over tasks of each task's mean NLL (fp32 log-softmax), or the
    ``task_weights``-weighted mean."""
    logits = multitask_forward(program, flat, x)
    losses = []
    for t, lg in enumerate(logits):
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[t].long()[:, None]).mean()
        losses.append(nll)
    stacked = torch.stack(losses)
    if task_weights is not None:
        return torch.sum(stacked * task_weights) / torch.sum(task_weights)
    return stacked.mean()
