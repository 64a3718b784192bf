"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_every_package_is_covered():
    """The checks below walk every module of the port, the input-adaptive
    package's, the training slice's, the two examples, the mesh's and the
    modules the LM, MoE and training mesh changed included."""
    assert {"repro_torch.models.layers", "repro_torch.models.cache",
            "repro_torch.models.moe", "repro_torch.models.transformer",
            "repro_torch.models.ssm", "repro_torch.models.hybrid",
            "repro_torch.models.encdec", "repro_torch.models.registry",
            "repro_torch.kernels.ops", "repro_torch.serving.engine",
            "repro_torch.serving.batching", "repro_torch.launch.serve",
            "repro_torch.training.checkpoint"} <= set(_modules())
    assert {"repro_torch.adaptive", "repro_torch.adaptive.gating",
            "repro_torch.sharding", "repro_torch.sharding.policy",
            "repro_torch.sharding.utils", "repro_torch.sharding.collectives",
            "repro_torch.launch.mesh",
            "repro_torch.adaptive.gate_model", "repro_torch.adaptive.policy",
            "repro_torch.core.executor", "repro_torch.serving.session",
            "repro_torch.training", "repro_torch.training.optimizer",
            "repro_torch.training.train_loop", "repro_torch.training.checkpoint",
            "repro_torch.launch.train", "repro_torch.data.synthetic",
            "repro_torch.examples.train_multitask",
            "repro_torch.examples.serve_multitask"} <= set(_modules())
    assert {"repro_torch.launch.roofline", "repro_torch.launch.specs",
            "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline_md"} <= set(_modules())


def test_importing_the_launch_analysis_loads_no_jax_and_makes_no_group():
    """``dryrun`` and ``op_cost`` import without JAX and without a process
    group: the fake world is made by ``fake_world``, never at import (the
    reference's ``dryrun`` sets ``XLA_FLAGS`` at import; the port does
    nothing)."""
    code = (
        "import os, sys\n"
        "env = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.op_cost\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert os.environ == env\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONDONTWRITEBYTECODE": "1"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_only_the_dry_run_touches_the_fake_process_group():
    """``torch.testing._internal.distributed.fake_pg`` is an internal API:
    one module of the port uses it."""
    users = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if "fake_pg" in p.read_text())
    assert users == ["launch/dryrun.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONDONTWRITEBYTECODE": "1"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_points_raise_without_cuda():
    from repro_torch.core.task_graph import TaskGraph
    from repro_torch.models.multitask import build_cnn_program

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cnn_program(TaskGraph.fully_separate(2, 3), [4, 4],
                          generator=torch.Generator().manual_seed(0))


def test_train_launcher_raises_without_cuda():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "mistral-nemo-12b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("example", ["train_multitask", "serve_multitask"])
def test_examples_raise_without_cuda(example):
    """The two examples default to the card: without one they raise rather
    than run on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    module = importlib.import_module(f"repro_torch.examples.{example}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--steps", "1"] if example == "train_multitask" else [])


def test_make_mesh_raises_without_cuda():
    """A mesh defaults to the card: without one ``make_mesh`` raises before
    it makes any process group, and never falls back to a CPU mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_raise_without_cuda_and_leave_no_process_group(launcher):
    """The launchers run under a mesh on the card by default: without one
    they raise before any world is made, and leave no process group."""
    import importlib

    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    module = importlib.import_module(f"repro_torch.launch.{launcher}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--arch", "mistral-nemo-12b", "--smoke", "--steps", "1"])
    assert not dist.is_initialized()


def test_launcher_world_of_one_is_ended():
    """``launcher_world`` on the CPU makes a gloo world of one for its body
    (a mesh can be made in it) and ends it on exit, also when the body
    raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import launcher_world, make_host_mesh

    with launcher_world("cpu") as made:
        assert made and dist.get_world_size() == 1
        assert tuple(make_host_mesh(device="cpu").shape) == (1, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256 ranks"):
        with launcher_world("cpu"):
            from repro_torch.launch.mesh import make_production_mesh

            make_production_mesh(device="cpu")
    assert not dist.is_initialized()
