"""The port's train step on a mesh — ``lm_loss``, ``loss_and_grads`` and
``make_train_step`` under a ``ShardingPolicy``, with parameters, gradients
and AdamW moments as ``DTensor``s — held against the JAX package's jitted
step on the same ``(data, model)`` mesh from the same weights: (4, 2), and
(2, 4) for mistral-nemo-12b, whose 2 KV heads do not divide the 4-way model
axis (each pair of its ranks shares a KV head; granite-34b's one KV head
does not divide the 2-way axis of (4, 2) either).

The port's side runs in one world of 8 gloo ranks to the design of
``tests/test_torch_mesh_serving.py``: 8 child processes, each this file
run as a script (``python tests/test_torch_train_mesh.py RANK DIR``; no
JAX, no reference package), joined through a ``FileStore``, running every
case of :data:`CASES` in lockstep on its mesh, then saving their
results with ``np.save`` and destroying their process group; the fixture
waits at most :data:`WORLD_SECONDS`.  No process group is made in the
pytest process (the launcher test runs the port's launcher in a
subprocess).

Checked for each case: loss, lr and grad norm; every gradient leaf within
1e-4 of its largest |g| (against the reference's ``value_and_grad`` of the
same batch); the updated params within the tolerances of
``tests/test_torch_training.py``; every updated parameter and moment in
its parameter's placements.  Also: ``grad_accum=2``; a checkpoint saved on
the mesh (each leaf gathered whole) restores bit for bit off the mesh, in
the reference's ``restore_checkpoint`` and back onto the mesh in its
layout; the train launcher on the host mesh gives the reference
launcher's losses, and ``--production-mesh`` raises in this world.
"""
import datetime
import json
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
# The hard limit on the world: alone it takes ~60 s of scenarios; the
# margin is for a loaded machine (a full test run's other workers).
WORLD_SECONDS = 400
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
# (arch, policy, grad_accum, mesh)
CASES = [
    ("mistral-nemo-12b", "tp", 1, "4x2"), ("mistral-nemo-12b", "fsdp_tp", 1, "4x2"),
    ("qwen2-moe-a2.7b", "expert_tp", 1, "4x2"), ("qwen2-moe-a2.7b", "fsdp_expert", 1, "4x2"),
    ("mamba2-780m", "fsdp_tp", 1, "4x2"), ("zamba2-2.7b", "tp", 1, "4x2"),
    ("whisper-medium", "tp", 1, "4x2"), ("mistral-nemo-12b", "fsdp_tp", 2, "4x2"),
    ("granite-34b", "tp", 1, "4x2"), ("mistral-nemo-12b", "tp", 1, "2x4"),
]
ARCHS = sorted({c[0] for c in CASES})
CKPT_CASE = ("mistral-nemo-12b", "fsdp_tp", 1, "4x2")
BATCH = 8
SEQ = {"qwen2-moe-a2.7b": 64}  # 64 tokens: the MoE routes one group per row
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SCALAR = dict(rtol=2e-5, atol=1e-6)
GRAD_REL = 1e-4
PARAM_ATOL = 2e-6
G_FLOOR = 1e-6  # |g| below which AdamW's first step is not compared


def _case_id(case):
    arch, policy, accum, mesh = case
    return (f"{arch}-{policy}" + (f"-accum{accum}" if accum > 1 else "")
            + (f"-{mesh}" if mesh != "4x2" else ""))


def _batch_for(arch, vocab, enc_inputs, encdec):
    rng = np.random.default_rng(sum(map(ord, arch)))
    seq = SEQ.get(arch, 32)
    tokens = rng.integers(0, vocab, (BATCH, seq)).astype(np.int32)
    if encdec:
        feats = rng.standard_normal((BATCH, seq, enc_inputs)).astype(np.float32)
        return {"features": feats, "tokens": tokens}
    return tokens


def _flat(tree, prefix=()):
    """{path: numpy leaf} of a nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (str(key),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


# ==========================================================================
# The port's side: one rank of the world (no JAX, no reference package)
# ==========================================================================

def _numpy_tree(tree):
    """A tree of tensors (``DTensor``s gathered whole) as numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    return t.detach().numpy()


def _placements(tree):
    return [str(tuple(t.placements)) for t in _leaves(tree)]


def _leaves(tree):
    from repro_torch._device import tree_leaves

    return tree_leaves(tree)


def _w_train(ctx, arch, policy_name, accum, mesh_name, meshes, workdir):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models.multitask import params_from_reference
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.policy import POLICIES
    from repro_torch.sharding.utils import place_tree
    from repro_torch.training import (
        AdamWConfig, adamw_init, loss_and_grads, make_train_step, restore_checkpoint,
        save_checkpoint,
    )

    policy = POLICIES[policy_name]
    model = get_model(get_smoke_config(arch))
    params = params_from_reference(ctx["inputs"]["params"][arch], device="cpu")
    batch = ctx["inputs"]["batches"][arch]
    mesh = meshes[mesh_name]
    out = {}
    with set_mesh(mesh):
        mp = place_tree(params, model.param_specs(policy), mesh)
        loss, parts, grads = loss_and_grads(model, mp, batch, accum, policy)
        new, opt, metrics = make_train_step(model, AdamWConfig(**OPT), policy, grad_accum=accum)(
            mp, adamw_init(mp), batch)
        want = _placements(mp)
        out.update(
            loss=float(metrics["loss"]), grads_loss=float(loss), lr=float(metrics["lr"]),
            grad_norm=float(metrics["grad_norm"]), grads=_numpy_tree(grads),
            new=_numpy_tree(new), params_kept=_placements(new) == want,
            grads_kept=_placements(grads) == want,
            moments_kept=_placements(opt.mu) == want == _placements(opt.nu),
            step=int(opt.step))
        if (arch, policy_name, accum, mesh_name) == CKPT_CASE:
            path = str(Path(workdir) / f"ckpt_rank{ctx['rank']}.npz")
            save_checkpoint(path, {"params": new}, step=1)
            back, step = restore_checkpoint(path, {"params": new})
            out["ckpt"] = {
                "path": path, "step": step,
                "bits_equal": all(torch.equal(a.to_local(), b.to_local())
                                  for a, b in zip(_leaves(back), _leaves(new))),
                "placements_kept": _placements(back) == _placements(new)}
    return out


def _w_production_mesh(ctx, meshes, workdir):
    from repro_torch.launch import train

    try:
        train.main(["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu",
                    "--production-mesh"])
    except ValueError as err:
        return {"raised": str(err)}
    return {"raised": None}


SCENARIOS = {
    **{_case_id(c): (lambda ctx, m, w, c=c: _w_train(ctx, *c, m, w)) for c in CASES},
    "production_mesh": _w_production_mesh,
}


def _child_main(rank: int, workdir: Path) -> None:
    """One rank: join the world, run every scenario in lockstep, save."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(workdir / "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        with open(workdir / "inputs.pkl", "rb") as f:
            ctx = {"inputs": pickle.load(f), "rank": rank}
        meshes = {name: make_mesh(shape, ("data", "model"), device="cpu")
                  for name, shape in MESHES.items()}
        results = {}
        for name, fn in SCENARIOS.items():
            t0 = time.perf_counter()
            try:
                results[name] = fn(ctx, meshes, workdir)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
            print(f"rank {rank} {name} {time.perf_counter() - t0:.2f}s", flush=True)
        results["forbidden_imports"] = sorted(
            m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        np.save(workdir / f"rank{rank}.npy", np.array(results, dtype=object), allow_pickle=True)
    finally:
        dist.destroy_process_group()


# ==========================================================================
# The pytest side: the world, the reference, the checks
# ==========================================================================

_CHILDREN = []


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_flat(tree):
    """{port path: numpy leaf} of a reference tree of dicts."""
    import jax

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    return {key(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference():
    """The weights, the batches and the reference's results: its gradients
    (``value_and_grad`` of ``lm_loss``) and its jitted train step on each
    case's mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import configs as r_configs
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.launch.mesh import set_mesh as r_set_mesh
    from repro.models import get_model as r_get_model
    from repro.sharding.policy import POLICIES as R_POLICIES
    from repro.sharding.utils import fit_specs as r_fit_specs
    from repro.training import AdamWConfig as RAdamWConfig
    from repro.training import adamw_init as r_adamw_init
    from repro.training import lm_loss as r_lm_loss
    from repro.training import make_train_step as r_make_train_step

    meshes = {name: r_make_mesh(shape, ("data", "model")) for name, shape in MESHES.items()}
    inputs = {"params": {}, "batches": {}}
    models, raw, grads = {}, {}, {}
    for arch in ARCHS:
        cfg = r_configs.get_smoke_config(arch)
        models[arch] = r_get_model(cfg)
        raw[arch] = jax.jit(models[arch].init)(jax.random.PRNGKey(0))
        inputs["params"][arch] = _np_tree(raw[arch])
        inputs["batches"][arch] = _batch_for(arch, cfg.raw_vocab_size, cfg.enc_inputs,
                                             cfg.family == "encdec")
    out = {"inputs": inputs, "raw": raw, "steps": {}}
    for arch, policy_name, accum, mesh_name in CASES:
        mesh = meshes[mesh_name]
        with r_set_mesh(mesh):
            policy, model = R_POLICIES[policy_name], models[arch]
            spec = r_fit_specs(raw[arch], model.param_specs(policy), mesh)
            placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  raw[arch], spec)
            b = inputs["batches"][arch]
            b = ({k: jnp.asarray(v) for k, v in b.items()} if isinstance(b, dict)
                 else jnp.asarray(b))
            if arch not in grads:
                (loss, _), g = jax.jit(jax.value_and_grad(
                    lambda p, bb: r_lm_loss(model, p, bb, policy), has_aux=True))(placed, b)
                grads[arch] = (float(loss), _ref_flat(g))
            step = jax.jit(r_make_train_step(model, RAdamWConfig(**OPT), policy,
                                             grad_accum=accum))
            new, opt, metrics = step(placed, r_adamw_init(placed), b)
            out["steps"][(arch, policy_name, accum, mesh_name)] = {
                "metrics": {k: float(metrics[k]) for k in ("loss", "lr", "grad_norm")},
                "new": _ref_flat(new), "step": int(opt.step)}
    out["grads"] = grads
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, reference):
    """Run the 8-rank world once; returns (workdir, each rank's results)."""
    workdir = tmp_path_factory.mktemp("train_mesh_world")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(reference["inputs"], f)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "PYTHONDONTWRITEBYTECODE": "1"}
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(workdir)],
                              cwd=ROOT, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    _CHILDREN.extend(procs)
    deadline = time.monotonic() + WORLD_SECONDS
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        overran = [p for p in procs if p.poll() is None]
        for p in overran:
            p.kill()
        for p in procs:
            p.wait()
        for f in logs:
            f.close()
    tail = (workdir / "rank0.log").read_text()[-4000:]
    if overran:
        pytest.fail(f"the world ran over {WORLD_SECONDS} s; rank 0's log:\n{tail}")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"ranks {bad} failed; rank {bad[0]}'s log:\n"
                    + (workdir / f"rank{bad[0]}.log").read_text()[-4000:])
    return [np.load(workdir / f"rank{r}.npy", allow_pickle=True).item() for r in range(WORLD)]


def _scenario(world, name, rank=0):
    res = world[rank][name]
    if "error" in res:
        pytest.fail(f"{name} failed on rank {rank}:\n{res['error']}")
    return res


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_train_step_on_mesh_matches_reference(world, reference, case):
    got = _scenario(world, _case_id(case))
    want = reference["steps"][case]
    r_loss, r_grads = reference["grads"][case[0]]
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(got[k], want["metrics"][k], **SCALAR, err_msg=k)
    np.testing.assert_allclose(got["grads_loss"], r_loss, **SCALAR)
    assert got["step"] == want["step"] == 1
    g = _flat(got["grads"])
    assert g.keys() == r_grads.keys()
    for key, w in r_grads.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g[key] - w).max())
        assert err <= GRAD_REL * scale + 1e-9, f"{key}: max err {err} vs max |g| {scale}"
    new = _flat(got["new"])
    for key, w in want["new"].items():
        big = np.abs(r_grads[key]) > max(G_FLOOR, 10 * GRAD_REL * float(np.abs(r_grads[key]).max()))
        np.testing.assert_allclose(new[key][big], w[big], atol=PARAM_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_train_step_keeps_every_placement(world, case):
    got = _scenario(world, _case_id(case))
    assert got["params_kept"] and got["grads_kept"] and got["moments_kept"]


def test_mesh_checkpoint_restores_everywhere(world, reference):
    """Saved on the mesh (each leaf whole): restores onto the mesh in its
    layout, off the mesh, and in the reference's ``restore_checkpoint``,
    bit for bit; every rank wrote the same bytes."""
    from repro.training import restore_checkpoint as r_restore
    from repro_torch.models.multitask import params_from_reference
    from repro_torch.training import restore_checkpoint

    got = _scenario(world, _case_id(CKPT_CASE))["ckpt"]
    assert got["step"] == 1 and got["bits_equal"] and got["placements_kept"]
    paths = [_scenario(world, _case_id(CKPT_CASE), r)["ckpt"]["path"] for r in range(WORLD)]
    blobs = [dict(np.load(p)) for p in paths]
    assert all(b.keys() == blobs[0].keys() for b in blobs)
    assert all(np.array_equal(b[k], blobs[0][k]) for b in blobs for k in b)
    want = _flat(_scenario(world, _case_id(CKPT_CASE))["new"])
    arch = CKPT_CASE[0]
    like = {"params": params_from_reference(reference["inputs"]["params"][arch], device="cpu")}
    off, step = restore_checkpoint(paths[0], like)
    assert step == 1
    off = _flat(_numpy_tree(off["params"]))
    assert all(np.array_equal(off[k], want[k]) for k in want)
    ref, step = r_restore(paths[0], {"params": reference["raw"][arch]})
    assert step == 1
    ref = _ref_flat(ref["params"])
    assert all(np.array_equal(ref[k], want[k]) for k in want)


_LAUNCH = r"""
import json, pickle, sys
import torch.distributed as dist
from repro_torch.launch import train
from repro_torch.models.multitask import params_from_reference
with open(sys.argv[1], "rb") as f:
    params = params_from_reference(pickle.load(f), device="cpu")
out = train.main(["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu",
                  "--steps", "3", "--batch", "2", "--seq", "32"], params=params)
print(json.dumps({"history": out["history"], "group_left": dist.is_initialized()}))
"""


def test_train_launcher_on_host_mesh_gives_reference_losses(tmp_path):
    """``repro_torch.launch.train`` in a subprocess (its own world of one,
    the (1, 1) host mesh, params placed by ``fit_specs``) from the
    reference's ``init(PRNGKey(0))`` weights, against the reference
    launcher's loop on its host mesh: each step's loss, lr and grad
    norm."""
    import jax
    import jax.numpy as jnp

    from repro import configs as r_configs
    from repro.data import lm_batches as r_lm_batches
    from repro.launch.mesh import make_host_mesh, set_mesh as r_set_mesh
    from repro.models import get_model as r_get_model
    from repro.sharding.policy import TP_POLICY as R_TP
    from repro.training import AdamWConfig as RAdamWConfig
    from repro.training import adamw_init as r_adamw_init
    from repro.training import make_train_step as r_make_train_step

    steps, batch, seq = 3, 2, 32
    cfg = r_configs.get_smoke_config("mistral-nemo-12b")
    model = r_get_model(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(_np_tree(params), f)
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCH, str(tmp_path / "params.pkl")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONDONTWRITEBYTECODE": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not got["group_left"]
    with r_set_mesh(make_host_mesh()):
        opt = r_adamw_init(params)
        step_fn = jax.jit(r_make_train_step(model, RAdamWConfig(
            lr=3e-4, warmup_steps=max(steps // 10, 1), total_steps=steps), R_TP))
        it = r_lm_batches(cfg.vocab_size, batch, seq, seed=0)
        for step in range(steps):
            params, opt, m = step_fn(params, opt, jnp.asarray(next(it)))
            for k in ("loss", "lr", "grad_norm"):
                np.testing.assert_allclose(got["history"][step][k], float(m[k]), rtol=1e-4,
                                           err_msg=f"step {step} {k}")


def test_production_mesh_raises_in_this_world(world):
    assert "needs a world of 256 ranks; this world has 8" in (
        _scenario(world, "production_mesh")["raised"] or "")


def test_ranks_agree(world):
    """Every rank took the same step: the same metrics, gradients and
    updated params, bit for bit."""
    for rank in range(1, WORLD):
        for case in CASES:
            a, b = _scenario(world, _case_id(case)), _scenario(world, _case_id(case), rank)
            for k in ("loss", "lr", "grad_norm"):
                assert a[k] == b[k], (rank, case, k)
            for k in ("grads", "new"):
                fa, fb = _flat(a[k]), _flat(b[k])
                assert all(np.array_equal(fa[p], fb[p]) for p in fa), (rank, case, k)


def test_children_import_neither_jax_nor_the_reference(world):
    assert all(rank["forbidden_imports"] == [] for rank in world)


def test_zz_no_process_group_in_pytest_and_no_child_left():
    """Runs last in this file: the world lived in its children only."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert all(p.poll() is not None for p in _CHILDREN)


if __name__ == "__main__":
    _child_main(int(sys.argv[1]), Path(sys.argv[2]))
