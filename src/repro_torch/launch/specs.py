"""Meta stand-ins for a step's parameters, optimizer state and inputs, and
the plan of one (architecture x input shape x mesh) dry run, the PyTorch
port of ``repro.launch.specs``.

The reference builds ``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``
and hands ``jit`` the shardings fitted to the mesh.  The port builds
``meta`` tensors (``model.init(generator, device="meta")`` draws nothing,
so nemotron-4-340b's 341 B parameters take no memory) and places them on a
``DeviceMesh`` as ``DTensor``s fitted by ``fit_specs`` over the model's
``param_specs(policy)`` and ``cache_spec(policy)``: the placements are the
DTensors themselves, so the reference's ``_compat_shardings`` has no
counterpart.  :func:`make_plan` needs the mesh's process group (a real
world, or :func:`repro_torch.launch.dryrun.fake_world`).

Policy auto-selection, as the reference: per-device bytes under plain TP =
(params + 8 bytes a parameter of AdamW moments when training) / the model
axis of 16; above 0.6 of a device's memory the parameters (and the moments
with them) shard over the data axis as well (FSDP).  The budget is one
NVIDIA H100 80GB HBM3's 80 GB, not the reference's TPU v5e's 16 GB, which
moves nine (arch, shape) pairs from ``fsdp_tp`` to ``tp``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch._device import tree_map
from repro_torch.models.cache import place_cache
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.registry import ModelApi, get_model
from repro_torch.sharding.policy import FSDP_TP_POLICY, POLICIES, TP_POLICY, ShardingPolicy
from repro_torch.sharding.utils import place_tree, tree_bytes
from repro_torch.training.optimizer import AdamWConfig, AdamWState
from repro_torch.training.train_loop import make_train_step

HBM_PER_DEVICE = 80e9  # NVIDIA H100 80GB HBM3


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the long-context SWA override for long_500k (DESIGN §5)."""
    if shape.name == "long_500k" and cfg.long_context_window is not None:
        return dataclasses.replace(cfg, sliding_window=cfg.long_context_window)
    return cfg


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Principled skips (recorded in DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def param_shapes(model: ModelApi) -> Any:
    """The parameters as ``meta`` tensors: their shapes and dtypes, nothing
    drawn or allocated."""
    return model.init(torch.Generator(), device="meta")


def opt_shapes(params: Any) -> AdamWState:
    """AdamW's state for ``meta`` ``params`` (placed or not): fp32 moments
    alike in shape, device and placements, and the step, a real int32 0 on
    the CPU (``adamw_update`` reads it)."""
    f32 = lambda p: torch.empty_like(p, dtype=torch.float32)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(f32, params), nu=tree_map(f32, params))


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """``meta`` tensors of the step's *data* inputs: the reference's shapes
    and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda shp: torch.empty(shp, dtype=torch.int32, device="meta")  # noqa: E731
    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {
                "batch": {
                    "features": torch.empty((b, s, cfg.enc_inputs),
                                            dtype=cfg.activation_dtype(), device="meta"),
                    "tokens": tok((b, s)),
                }
            }
        return {"batch": tok((b, s))}
    # decode: ONE new token against a cache of seq_len
    model = get_model(cfg)
    return {
        "token": tok((b,)),
        "cache": model.cache_shape(b, s),
        "cache_len": tok(()),
    }


def select_policy(
    cfg: ModelConfig, shape: InputShape, requested: str = "auto"
) -> ShardingPolicy:
    if requested != "auto":
        return POLICIES[requested]
    pbytes = tree_bytes(param_shapes(get_model(cfg)))
    model_par = 16
    per_dev = pbytes / model_par
    if shape.kind == "train":
        per_dev += 8.0 * (pbytes / cfg.params_dtype().itemsize) / model_par
    # Leave headroom for activations / caches.
    if per_dev > 0.6 * HBM_PER_DEVICE:
        return FSDP_TP_POLICY
    return TP_POLICY


@dataclasses.dataclass
class LoweringPlan:
    """Everything one (arch x shape x mesh) dry run runs: ``step_fn`` on
    ``args``, whose parameters, optimizer moments and cache are ``meta``
    ``DTensor``s placed on the mesh.  The batch and the token are plain
    tensors every rank holds, which the models place themselves."""

    cfg: ModelConfig
    shape: InputShape
    policy: ShardingPolicy
    step_fn: Callable
    args: Tuple[Any, ...]
    kind: str


def make_plan(
    cfg: ModelConfig,
    shape: InputShape,
    mesh: Any,
    policy: Union[str, ShardingPolicy] = "auto",
) -> LoweringPlan:
    """The plan of ``shape``'s step for ``cfg`` on ``mesh``: the train step
    (``make_train_step``), a prefill or a decode step.  Decode runs at the
    last slot of a full cache (``cache_len = seq_len - 1``).  Call it with
    ``mesh`` installed (``launch.mesh.set_mesh``)."""
    cfg = config_for_shape(cfg, shape)
    if not isinstance(policy, ShardingPolicy):
        policy = select_policy(cfg, shape, policy)
    model = get_model(cfg)
    params = place_tree(param_shapes(model), model.param_specs(policy), mesh)
    spec_in = input_specs(cfg, shape)

    if shape.kind == "train":
        step = make_train_step(model, AdamWConfig(), policy)
        return LoweringPlan(cfg, shape, policy, step,
                            (params, opt_shapes(params), spec_in["batch"]), "train")

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return model.prefill(params, batch, policy)

        return LoweringPlan(cfg, shape, policy, prefill_step, (params, spec_in["batch"]),
                            "prefill")

    cache = place_cache(spec_in["cache"], model.cache_spec(policy), mesh)

    def serve_step(params, token, cache, cache_len):
        return model.decode_step(params, token, cache, cache_len, policy)

    return LoweringPlan(cfg, shape, policy, serve_step,
                        (params, spec_in["token"], cache, shape.seq_len - 1), "decode")
