"""The port's roofline terms (``repro_torch.launch.roofline``) against the
JAX package's ``repro.launch.roofline``, and the hand kernels' formulas.

``model_flops_estimate`` and ``active_params`` equal the reference's on all
ten full configs at the four ``INPUT_SHAPES``, each from the parameter count
of the reference's ``jax.eval_shape`` of its ``init``; the port's count
comes from its own ``init`` on ``meta`` (which draws nothing: nemotron-4-340b
builds in well under a second) and equals the reference's for every
config.  ``RooflineReport`` keeps the reference's fields and ``to_dict``
keys on the H100's constants.  The kernel formulas give ``PERF.md`` §6's
bound column to four significant figures.
"""
import dataclasses
import functools
import math
import time

import jax.numpy as jnp
import pytest
import torch

from repro import configs as r_configs
from repro.launch import roofline as r_roofline
from repro.launch.specs import param_shapes as r_param_shapes
from repro.models import get_model as r_get_model
from repro.models.config import INPUT_SHAPES as R_SHAPES
from repro.sharding.utils import tree_bytes as r_tree_bytes
from repro_torch import configs as p_configs
from repro_torch.launch import roofline
from repro_torch.launch.specs import param_shapes
from repro_torch.models.config import get_shape
from repro_torch.models.registry import get_model
from repro_torch.sharding.utils import tree_bytes

ARCHS = r_configs.list_archs()
SHAPES = [s.name for s in R_SHAPES]


@functools.lru_cache(maxsize=None)
def r_n_params(arch: str) -> int:
    cfg = r_configs.get_config(arch)
    return int(r_tree_bytes(r_param_shapes(r_get_model(cfg)))
               / jnp.dtype(cfg.param_dtype).itemsize)


@functools.lru_cache(maxsize=None)
def p_n_params(arch: str) -> int:
    cfg = p_configs.get_config(arch)
    return int(tree_bytes(param_shapes(get_model(cfg))) / cfg.params_dtype().itemsize)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_counts_the_references_params(arch):
    t0 = time.perf_counter()
    params = param_shapes(get_model(p_configs.get_config(arch)))
    assert time.perf_counter() - t0 < 30
    assert all(t.device.type == "meta" for t in _leaves(params))
    assert p_n_params(arch) == r_n_params(arch)


def _leaves(tree):
    from repro_torch._device import tree_leaves

    return tree_leaves(tree)


def test_nemotron_has_the_references_341b_params():
    assert round(p_n_params("nemotron-4-340b") / 1e9, 2) == 341.03


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_model_flops_and_active_params_equal_the_references(arch, shape):
    r_cfg, p_cfg = r_configs.get_config(arch), p_configs.get_config(arch)
    n = r_n_params(arch)
    r_active = r_roofline.active_params(r_cfg, n)
    assert roofline.active_params(p_cfg, n) == r_active
    r_shape = next(s for s in R_SHAPES if s.name == shape)
    assert roofline.model_flops_estimate(p_cfg, get_shape(shape), n, r_active) == \
        r_roofline.model_flops_estimate(r_cfg, r_shape, n, r_active)
    assert roofline.model_flops_estimate(p_cfg, get_shape(shape), n) == \
        r_roofline.model_flops_estimate(r_cfg, r_shape, n)


def _report(module, **over):
    fields = dict(arch="a", shape="train_4k", mesh="single", chips=256, hlo_flops=3e18,
                  hlo_bytes=2e15, coll_bytes=4e11, coll_breakdown={"all-gather": 4e11},
                  model_flops=1e18, bytes_per_device=5e10, peak_memory_per_device=7e10)
    fields.update(over)
    return module.RooflineReport(**fields)


def test_report_keeps_the_references_fields_on_the_h100s_constants():
    mine, ref = _report(roofline), _report(r_roofline)
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert list(mine.to_dict()) == list(ref.to_dict())
    assert (roofline.PEAK_FLOPS, roofline.FP32_PEAK_FLOPS, roofline.HBM_BW,
            roofline.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    assert mine.t_compute == 3e18 / (256 * 989e12)
    assert mine.t_memory == 2e15 / (256 * 3.35e12)
    assert mine.t_collective == 4e11 / 450e9
    assert mine.useful_flops_ratio == ref.useful_flops_ratio == 1e18 / 3e18
    assert mine.dominant == "compute"
    assert _report(roofline, hlo_flops=0.0).useful_flops_ratio == 0.0
    # The same figures over the reference's v5e constants, which the port
    # does not use.
    assert ref.t_compute == mine.t_compute * roofline.PEAK_FLOPS / r_roofline.PEAK_FLOPS


def test_collective_totals_name_every_kind():
    tot = roofline.collective_totals({"all-gather": 8.0, "other": 2.0})
    assert tot == {"all-gather": 8.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
                   "all-to-all": 0.0, "collective-permute": 0.0, "other": 2.0, "total": 10.0}
    assert tuple(roofline.COLLECTIVE_KINDS) == tuple(r_roofline._COLLECTIVES)


def test_step_mfu_and_roofline_share():
    assert roofline.step_mfu(989e12, 1.0) == 1.0
    assert roofline.step_mfu(0.5 * 989e12, 2.0) == 0.25
    assert roofline.roofline_share(989e12, 0.0, 2.0) == 0.5
    assert roofline.roofline_share(0.0, 3.35e12, 1.0) == 1.0


def test_train_model_flops_counts_weights_and_pairs():
    cfg = p_configs.get_smoke_config("mistral-nemo-12b")
    d, hd = cfg.d_model, cfg.head_dim
    weights = cfg.num_layers * (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                                + 3 * d * cfg.d_ff) + d * cfg.vocab_size
    assert roofline.train_model_flops(cfg, 4, 64) == (
        6.0 * weights * 4 * 64 + 12.0 * cfg.num_layers * 4 * cfg.n_heads * (64 * 65 // 2) * hd)


@pytest.mark.parametrize("s,t,causal,window", [
    (1, 1, True, None), (40, 40, True, None), (40, 70, False, None), (70, 40, True, 24),
    (100, 100, False, 7), (33, 50, False, 20), (5, 3, True, 2),
])
def test_allowed_pairs_count_the_masks(s, t, causal, window):
    qp, kp = torch.arange(s)[:, None], torch.arange(t)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    assert roofline.allowed_pairs(s, t, causal, window) == int(mask.sum())


BF16 = torch.bfloat16


@pytest.mark.parametrize("name,work,dtype,bound_ms,by", [
    ("pearson 256 x 655,360", roofline.pearson_work(256, 655_360), torch.float32, 0.6435,
     "operations"),
    ("flash LM prefill 128x512x160", roofline.flash_work(4, 512, 512, 32, 8, 160, BF16, True,
                                                         None), BF16, 0.01565, "bytes"),
    ("flash backward, training shape", roofline.flash_bwd_work(4, 512, 512, 32, 8, 160, BF16,
                                                               True, None), BF16, 0.03138,
     "bytes"),
    ("flash whisper encoder, 548 zero-pad keys", roofline.flash_work(4, 1500, 2048, 16, 16, 64,
                                                                     BF16, False, None), BF16,
     0.05089, "operations"),
    ("flash mixtral window", roofline.flash_work(2, 4608, 4608, 48, 8, 128, BF16, True, 4096),
     BF16, 0.5212, "operations"),
    ("SSD mamba2", roofline.ssd_work(4, 2048, 48, 64, 128, 64, BF16), BF16, 0.03365, "bytes"),
    ("SSD backward mamba2", roofline.ssd_bwd_work(4, 2048, 48, 64, 128, 64, BF16, False), BF16,
     0.04852, "bytes"),
])
def test_kernel_formulas_give_perf_md_bounds(name, work, dtype, bound_ms, by):
    got = roofline.bound(work, dtype)
    assert got["bound_by"] == by, name
    assert float(f"{got['bound_ms']:.4g}") == bound_ms, (name, got["bound_ms"])
    assert math.isfinite(work["flops"]) and work["bytes"] > 0
