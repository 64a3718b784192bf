"""The port's dry-run plan (``repro_torch.launch.specs``) and dry run
(``repro_torch.launch.dryrun``) against the JAX package's
``repro.launch.specs``.

On every (architecture, input shape) pair of the zoo — ten full configs
by the four ``INPUT_SHAPES`` — ``config_for_shape`` and ``shape_supported``
equal the reference's; ``input_specs``, ``param_shapes`` and
``opt_shapes`` give ``meta`` tensors of the reference's
``ShapeDtypeStruct`` shapes and dtypes, leaf for leaf; ``select_policy``
picks the reference's policy on 31 pairs and differs on exactly nine,
each because the budget is an H100's 80 GB and not a TPU v5e's 16 GB.

``tests/test_launch_integration.py::test_make_plan_lowers_on_8_device_mesh``
re-pointed: the same five smoke cases, planned under ``tp`` on a (2, 4)
``(data, model)`` mesh of a fake 8-rank world and run once on ``meta``
under ``analyze_step``: FLOPs and bytes positive, collective bytes positive
in at least three, model FLOPs equal to the reference's; and ``run_one``
at the 16 x 16 production mesh (256 fake ranks) writes the documented
JSON.  The fake worlds run in one child process, this file run as a script
(``python tests/test_torch_specs.py OUT``), with its own time limit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD_SECONDS = 240
CASES = [
    ("granite-34b", ("t", 64, 8, "train")),
    ("mixtral-8x22b", ("p", 64, 8, "prefill")),
    ("mamba2-780m", ("d", 64, 8, "decode")),
    ("zamba2-2.7b", ("d", 64, 8, "decode")),
    ("whisper-medium", ("t", 64, 8, "train")),
]
RUN_ONE = (("whisper-medium", "prefill_32k"), ("granite-34b", "long_500k"))
#: (arch, shape) pairs whose policy the 80 GB budget moves from the
#: reference's fsdp_tp to tp.
POLICY_MOVES = {
    ("granite-34b", "train_4k"), ("granite-20b", "train_4k"), ("chameleon-34b", "train_4k"),
    ("nemotron-4-340b", "prefill_32k"), ("nemotron-4-340b", "decode_32k"),
    ("nemotron-4-340b", "long_500k"), ("mixtral-8x22b", "prefill_32k"),
    ("mixtral-8x22b", "decode_32k"), ("mixtral-8x22b", "long_500k"),
}
DOCUMENTED_KEYS = {
    "status", "kind", "policy", "n_params", "n_active_params", "trace_s", "memory", "kernels",
    "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown",
    "model_flops", "t_compute", "t_memory", "t_collective", "dominant", "useful_flops_ratio",
    "bytes_per_device", "peak_memory_per_device",
}


# ==========================================================================
# The child: the fake worlds (no JAX, no reference package)
# ==========================================================================

def _child(out_dir: str) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import fake_world, run_one
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.launch.op_cost import analyze_step
    from repro_torch.launch.specs import make_plan
    from repro_torch.models.config import InputShape
    from repro_torch.sharding.utils import tree_bytes

    torch.set_num_threads(1)
    out = {"plans": {}}
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
        with set_mesh(mesh):
            for arch, shape in CASES:
                cfg = get_smoke_config(arch)
                plan = make_plan(cfg, InputShape(*shape), mesh, "tp")
                acc = analyze_step(plan.step_fn, *plan.args)
                out["plans"][f"{arch}/{plan.kind}"] = {
                    "flops": acc["flops"], "bytes": acc["bytes"],
                    "coll": acc["collective_bytes"], "policy": plan.policy.name,
                    "n_params": tree_bytes(plan.args[0]) // cfg.params_dtype().itemsize,
                    "kernels": acc["kernels"],
                }
    out["run_one"] = [run_one(arch, shape, "single", "auto", os.path.join(out_dir, "dryrun"),
                              verbose=False)
                      for arch, shape in RUN_ONE]
    with open(os.path.join(out_dir, "world.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, __file__, str(out)], capture_output=True, text=True,
                         env=env, timeout=WORLD_SECONDS, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads((out / "world.json").read_text())
    result["dir"] = str(out / "dryrun")
    return result


if __name__ == "__main__":
    _child(sys.argv[1])
    sys.exit(0)


# ==========================================================================
# The tests
# ==========================================================================

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro.models import get_model as r_get_model  # noqa: E402
from repro.models.config import INPUT_SHAPES as R_SHAPES  # noqa: E402
from repro.models.config import InputShape as RInputShape  # noqa: E402
from repro.sharding.utils import tree_bytes as r_tree_bytes  # noqa: E402
from repro_torch import configs as p_configs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.config import get_shape  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCHS = r_configs.list_archs()
SHAPES = [s.name for s in R_SHAPES]
PAIRS = [(a, s) for a in ARCHS for s in SHAPES]


def _r_shape(name):
    return next(s for s in R_SHAPES if s.name == name)


def _jax_leaves(tree):
    """{path: (shape, dtype name)} of a reference ``ShapeDtypeStruct`` tree."""
    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(key(k) for k in path): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in flat}


def _torch_leaves(tree, path=()):
    """{path: (shape, dtype name)} of a port tree of tensors."""
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(_torch_leaves(v, path + (str(k),)))
    return out


@functools.lru_cache(maxsize=None)
def _r_params(arch):
    return r_specs.param_shapes(r_get_model(r_configs.get_config(arch)))


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_config_for_shape_and_support_equal_the_references(arch, shape):
    r_cfg = r_specs.config_for_shape(r_configs.get_config(arch), _r_shape(shape))
    p_cfg = specs.config_for_shape(p_configs.get_config(arch), get_shape(shape))
    assert p_cfg.sliding_window == r_cfg.sliding_window
    r_fields = dataclasses.asdict(r_cfg)
    assert {k: v for k, v in dataclasses.asdict(p_cfg).items() if k in r_fields} == \
        {k: r_fields[k] for k in dataclasses.asdict(p_cfg) if k in r_fields}
    assert specs.shape_supported(p_cfg, get_shape(shape)) == \
        r_specs.shape_supported(r_cfg, _r_shape(shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_shapes_equal_the_references(arch):
    params = specs.param_shapes(get_model(p_configs.get_config(arch)))
    assert _torch_leaves(params) == _jax_leaves(_r_params(arch))
    opt = specs.opt_shapes(params)
    r_opt = r_specs.opt_shapes(_r_params(arch))
    assert _torch_leaves(opt) == _jax_leaves(r_opt)
    assert opt.step.device.type == "cpu" and int(opt.step) == 0
    assert all(t.device.type == "meta" for t in (*_flat(opt.mu), *_flat(opt.nu)))


def _flat(tree):
    from repro_torch._device import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_equal_the_references(arch, shape):
    r_cfg = r_specs.config_for_shape(r_configs.get_config(arch), _r_shape(shape))
    p_cfg = specs.config_for_shape(p_configs.get_config(arch), get_shape(shape))
    got = specs.input_specs(p_cfg, get_shape(shape))
    assert _torch_leaves(got) == _jax_leaves(r_specs.input_specs(r_cfg, _r_shape(shape)))
    assert all(t.device.type == "meta" for t in _flat(got))


def _per_device_bytes(arch, shape):
    """The reference's rule: params (plus 8 bytes a parameter of moments
    when training) over the model axis of 16."""
    cfg = r_configs.get_config(arch)
    pbytes = r_tree_bytes(_r_params(arch))
    per_dev = pbytes / 16
    if _r_shape(shape).kind == "train":
        per_dev += 8.0 * (pbytes / jnp.dtype(cfg.param_dtype).itemsize) / 16
    return per_dev


def test_select_policy_moves_nine_pairs_by_the_budget():
    same, moved = [], set()
    for arch, shape in PAIRS:
        mine = specs.select_policy(p_configs.get_config(arch), get_shape(shape)).name
        ref = r_specs.select_policy(r_configs.get_config(arch), _r_shape(shape)).name
        if mine == ref:
            same.append((arch, shape))
            continue
        moved.add((arch, shape))
        assert (ref, mine) == ("fsdp_tp", "tp")
        per_dev = _per_device_bytes(arch, shape)
        assert 0.6 * r_specs.HBM_PER_CHIP < per_dev <= 0.6 * specs.HBM_PER_DEVICE
    assert len(same) == 31
    assert moved == POLICY_MOVES
    for name in ("tp", "fsdp_tp", "expert_tp", "fsdp_expert"):
        assert specs.select_policy(p_configs.get_config("mamba2-780m"), get_shape("train_4k"),
                                   name).name == name


@pytest.mark.parametrize("arch,shape", CASES)
def test_make_plan_runs_on_a_fake_8_rank_mesh(world, arch, shape):
    row = world["plans"][f"{arch}/{shape[3]}"]
    assert row["policy"] == "tp"
    assert row["flops"] > 0, row
    assert row["bytes"] > 0, row
    # Model FLOPs from the plan's parameters equal the reference's.
    r_cfg = r_configs.get_smoke_config(arch)
    r_n = int(r_tree_bytes(r_specs.param_shapes(r_get_model(r_cfg)))
              / jnp.dtype(r_cfg.param_dtype).itemsize)
    assert row["n_params"] == r_n
    from repro_torch.launch.roofline import active_params, model_flops_estimate
    from repro_torch.models.config import InputShape

    p_cfg = p_configs.get_smoke_config(arch)
    assert model_flops_estimate(p_cfg, InputShape(*shape), r_n, active_params(p_cfg, r_n)) == \
        r_roofline.model_flops_estimate(r_cfg, RInputShape(*shape), r_n,
                                        r_roofline.active_params(r_cfg, r_n))


def test_sharded_plans_communicate(world):
    assert sum(v["coll"] > 0 for v in world["plans"].values()) >= 3


def test_plans_launch_the_kernels_on_meta(world):
    """Training launches the flash (or SSD) backward; decode neither the
    flash forward nor the SSD."""
    plans = world["plans"]
    assert plans["granite-34b/train"]["kernels"]["flash_attention_bwd"]["launches"] > 0
    assert plans["mixtral-8x22b/prefill"]["kernels"]["flash_attention"]["launches"] > 0
    assert "ssd_scan" not in plans["mamba2-780m/decode"]["kernels"]
    assert plans["whisper-medium/train"]["kernels"]["flash_attention_bwd"]["launches"] > 0


def test_run_one_writes_the_documented_json(world):
    ok, skipped = world["run_one"]
    assert ok["status"] == "ok", ok
    assert set(ok) == DOCUMENTED_KEYS
    assert ok["chips"] == 256 and ok["mesh"] == "single" and ok["kind"] == "prefill"
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "peak_bytes"}
    assert ok["memory"]["peak_bytes"] >= ok["memory"]["argument_bytes"] > 0
    assert ok["hlo_flops"] > 0 and ok["hlo_bytes"] > 0 and ok["coll_bytes"] > 0
    assert ok["model_flops"] == r_roofline.model_flops_estimate(
        r_configs.get_config("whisper-medium"), _r_shape("prefill_32k"), ok["n_params"],
        ok["n_active_params"])
    assert skipped == {"arch": "granite-34b", "shape": "long_500k", "mesh": "single",
                       "status": "skipped", "reason": skipped["reason"]}
    for arch, shape in RUN_ONE:
        path = Path(world["dir"]) / f"{arch}__{shape}__single.json"
        assert json.loads(path.read_text())["status"] in ("ok", "skipped")


def test_roofline_md_renders_the_dry_runs(world):
    from repro_torch.launch.roofline_md import table

    lines = table(world["dir"])
    assert lines[0].startswith("| arch | shape | mesh | policy |")
    assert any(line.startswith("| whisper-medium | prefill_32k | single | tp |")
               for line in lines)
    assert any("granite-34b | long_500k" in line and "skipped" in line for line in lines)

