"""The port's LM serving on a mesh — ``LMServer`` and ``ContinuousBatcher``
under a ``ShardingPolicy`` with parameters, caches and activations as
``DTensor``s — held against the JAX package's mesh ``LMServer`` and
``ContinuousBatcher`` and against the port's own one-device server.

The port's side runs in one world of 8 gloo ranks, started once for the
whole file by a module-scoped fixture to the design of
``tests/test_torch_mesh_serving.py``: 8 child processes, each this file
run as a script (``python tests/test_torch_lm_mesh.py RANK DIR``), which
import neither JAX nor the JAX package, set one thread, join through a
``FileStore`` under the test's temporary directory, run every case of
:data:`SERVE_CASES` and the batcher in lockstep — first on a (4, 2)
``(data, model)`` mesh, then on a (2, 4) one, where mistral's 2 KV heads do
not divide the model axis and its cache shards the sequence (granite-34b's
one KV head divides neither model axis: its query heads' ranks share it) — save their
results with ``np.save`` and destroy their process group.  The fixture
waits at most :data:`WORLD_SECONDS`; no process group is made in the
pytest process.  The one-device runs are rank 0's alone.  The reference runs in the pytest process on a (4, 2)
mesh of the 8 forced host devices of ``tests/conftest.py``, from the same
``init(PRNGKey(0))`` weights (fp32 smoke configs).

The contract:

* tokens of ``LMServer.generate`` equal the reference's mesh server's and
  the port's one-device server's, on both meshes, for the dense, MoE
  (``expert_tp`` and ``fsdp_expert`` included), SSM, hybrid and enc-dec
  families; prefill logits within ``rtol=atol=1e-5``;
* the grown cache is in ``cache_spec(policy)``'s fitted layout and keeps
  it through a decode step;
* ``ContinuousBatcher`` tokens on mistral ``tp`` equal the reference's
  batcher's;
* each rank's collective kinds and bytes for one prefill and one decode
  step (``CollectiveRecorder``) are printed beside the reference's
  ``collective_breakdown`` of the compiled steps — not gated: DTensor and
  XLA's partitioner pick different collectives for one layout.
"""
import datetime
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
# The hard limit on the world: alone it takes ~85 s of scenarios; the
# margin is for a loaded machine (a full test run's other workers).
WORLD_SECONDS = 400
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
SERVE_CASES = [
    ("mistral-nemo-12b", "tp"), ("mistral-nemo-12b", "fsdp_tp"), ("granite-34b", "tp"),
    ("qwen2-moe-a2.7b", "tp"), ("qwen2-moe-a2.7b", "expert_tp"),
    ("qwen2-moe-a2.7b", "fsdp_expert"),
    ("mamba2-780m", "tp"), ("zamba2-2.7b", "fsdp_tp"), ("whisper-medium", "tp"),
]
ARCHS = sorted({a for a, _ in SERVE_CASES})
BATCH, STEPS = 8, 4
# qwen2-moe's prompt reaches 64 tokens, so its prefill routes one group per
# row (sharded with the batch) and its decode one group over the batch.
PROMPT = {"qwen2-moe-a2.7b": 64}
# The batcher's requests (prompt length, new tokens), served in waves of 4
# slots: two full waves, and a full wave then one of 2 rows.
BATCHER = {
    "full": ((5, 4), (9, 2), (3, 5), (7, 3), (6, 4), (4, 2), (8, 3), (2, 5)),
    "ragged": ((5, 4), (9, 2), (3, 5), (7, 3), (6, 4), (4, 2)),
}


def _prompt_len(arch):
    return PROMPT.get(arch, 12)


def _inputs_for(arch, cfg_vocab, enc_inputs, encdec):
    rng = np.random.default_rng(sum(map(ord, arch)))
    s0 = _prompt_len(arch)
    prompts = rng.integers(0, cfg_vocab, (BATCH, s0)).astype(np.int32)
    feats = (rng.normal(size=(BATCH, s0, enc_inputs)).astype(np.float32) if encdec else None)
    return prompts, feats


def _batcher_requests(vocab, case):
    rng = np.random.default_rng(11)
    return [(uid, rng.integers(0, vocab, (n,)).astype(np.int32), new)
            for uid, (n, new) in enumerate(BATCHER[case])]


# ==========================================================================
# The port's side: one rank of the world (no JAX, no reference package)
# ==========================================================================

def _model(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model

    return get_model(get_smoke_config(arch))


def _port_params(ctx, arch):
    from repro_torch.models.multitask import params_from_reference

    return params_from_reference(ctx["inputs"]["params"][arch], device="cpu")


def _layout(cache):
    """Each cache tensor's placements, as strings, by field path."""
    from repro_torch.models.cache import cache_leaves

    return [str(tuple(t.placements)) for t in cache_leaves(cache)]


def _spec_layout(model, cache, policy, mesh):
    from repro_torch.models.cache import cache_leaves, map_cache
    from repro_torch.sharding.utils import fit_spec, placements

    fitted = map_cache(lambda t, sp: placements(fit_spec(tuple(t.shape), sp, mesh), mesh),
                       cache, model.cache_spec(policy))
    return [str(tuple(p)) for p in cache_leaves(fitted)]


def _w_serve(ctx, arch, policy_name, mesh):
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.serving import LMServer
    from repro_torch.serving.engine import _grow_cache
    from repro_torch.sharding.collectives import CollectiveRecorder
    from repro_torch.sharding.policy import POLICIES
    from repro_torch.sharding.utils import place_tree

    policy = POLICIES[policy_name]
    model = _model(arch)
    params = _port_params(ctx, arch)
    prompts, feats = ctx["inputs"]["prompts"][arch]
    batch = model.make_batch(prompts, feats)
    s0 = prompts.shape[1]
    off_tokens = off_logits = None
    if ctx["rank"] == 0:  # one device's run: no rank but the first needs it
        off_tokens = LMServer(model, params).generate(prompts, STEPS, features=feats)
        off_logits = model.prefill(params, batch)[0].numpy()
    with set_mesh(mesh):
        mp = place_tree(params, model.param_specs(policy), mesh)
        tokens = LMServer(model, mp, policy).generate(prompts, STEPS, features=feats)
        with CollectiveRecorder() as rec_prefill:
            logits, cache = model.prefill(mp, batch, policy)
        logits = logits.full_tensor().numpy()
        cache = _grow_cache(model, cache, s0 + STEPS, s0, policy)
        grown = _layout(cache)
        want = _spec_layout(model, cache, policy, mesh)
        tok = torch.as_tensor(np.argmax(logits, axis=-1))
        with CollectiveRecorder() as rec_decode:
            model.decode_step(mp, tok, cache, s0, policy)
        kept = _layout(cache)
    return {"tokens": tokens, "off_tokens": off_tokens, "logits": logits,
            "off_logits": off_logits, "grown": grown, "spec_layout": want, "kept": kept,
            "collectives": {"prefill": (rec_prefill.breakdown(), rec_prefill.counts),
                            "decode": (rec_decode.breakdown(), rec_decode.counts)}}


def _w_batcher(ctx, case, mesh):
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.serving.batching import ContinuousBatcher, GenRequest
    from repro_torch.sharding.policy import TP_POLICY
    from repro_torch.sharding.utils import place_tree

    arch = "mistral-nemo-12b"
    model = _model(arch)
    params = _port_params(ctx, arch)

    def serve(p, **kw):
        b = ContinuousBatcher(model, p, slots=4, max_len=64, **kw)
        for uid, prompt, new in ctx["inputs"]["batcher"][case]:
            b.submit(GenRequest(uid=uid, prompt=prompt, max_new_tokens=new))
        return {r.uid: r.tokens for r in b.run()}

    off = serve(params) if ctx["rank"] == 0 else None
    with set_mesh(mesh):
        on = serve(place_tree(params, model.param_specs(TP_POLICY), mesh), policy=TP_POLICY)
    return {"tokens": on, "off_tokens": off}


def _scenarios():
    out = {}
    for mesh_name in MESHES:
        for arch, policy in SERVE_CASES:
            out[f"{mesh_name}/{arch}/{policy}"] = (
                mesh_name, lambda ctx, m, a=arch, p=policy: _w_serve(ctx, a, p, m))
        for case in BATCHER:
            out[f"{mesh_name}/batcher/{case}"] = (
                mesh_name, lambda ctx, m, c=case: _w_batcher(ctx, c, m))
    return out


SCENARIOS = _scenarios()


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
        for name, (mesh_name, fn) in SCENARIOS.items():
            t0 = time.perf_counter()
            try:
                results[name] = fn(ctx, meshes[mesh_name])
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


@pytest.fixture(scope="module")
def reference():
    """The reference's weights, the inputs, its mesh servers' tokens,
    logits and compiled collectives, and its mesh batcher's tokens."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro import configs as r_configs
    from repro.launch.hlo_cost import collective_breakdown
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.launch.mesh import set_mesh as r_set_mesh
    from repro.models import get_model as r_get_model
    from repro.serving import LMServer as RLMServer
    from repro.serving.batching import ContinuousBatcher as RBatcher
    from repro.serving.batching import GenRequest as RGenRequest
    from repro.serving.engine import _grow_cache as r_grow_cache
    from repro.sharding.policy import POLICIES as R_POLICIES
    from repro.sharding.utils import fit_specs as r_fit_specs

    mesh = r_make_mesh((4, 2), ("data", "model"))
    inputs = {"params": {}, "prompts": {}}
    models, raw = {}, {}
    for arch in ARCHS:
        cfg = r_configs.get_smoke_config(arch)
        models[arch] = r_get_model(cfg)
        raw[arch] = jax.jit(models[arch].init)(jax.random.PRNGKey(0))
        inputs["params"][arch] = _np_tree(raw[arch])
        inputs["prompts"][arch] = _inputs_for(arch, cfg.raw_vocab_size, cfg.enc_inputs,
                                              cfg.family == "encdec")
    vocab = r_configs.get_smoke_config("mistral-nemo-12b").raw_vocab_size
    inputs["batcher"] = {case: _batcher_requests(vocab, case) for case in BATCHER}
    out = {"inputs": inputs, "serve": {}}
    with r_set_mesh(mesh):
        for arch, policy_name in SERVE_CASES:
            policy, model = R_POLICIES[policy_name], models[arch]
            spec = r_fit_specs(raw[arch], model.param_specs(policy), mesh)
            placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  raw[arch], spec)
            prompts, feats = inputs["prompts"][arch]
            srv = RLMServer(model, placed, policy)
            f = None if feats is None else jnp.asarray(feats)
            tokens = srv.generate(jnp.asarray(prompts), steps=STEPS, features=f)
            batch = ({"features": f, "tokens": jnp.asarray(prompts)}
                     if feats is not None else jnp.asarray(prompts))
            logits, cache = srv._prefill(placed, batch)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            n = jnp.asarray(prompts.shape[1], jnp.int32)
            grown = r_grow_cache(model, cache, prompts.shape[1] + STEPS, prompts.shape[1])
            hlo = {"prefill": srv._prefill.lower(placed, batch).compile().as_text(),
                   "decode": srv._step.lower(placed, tok, grown, n).compile().as_text()}
            out["serve"][(arch, policy_name)] = {
                "tokens": np.asarray(tokens), "logits": np.asarray(logits),
                "collectives": {k: collective_breakdown(v) for k, v in hlo.items()}}
        arch, policy = "mistral-nemo-12b", R_POLICIES["tp"]
        spec = r_fit_specs(raw[arch], models[arch].param_specs(policy), mesh)
        placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              raw[arch], spec)
        out["batcher"] = {"full": _ref_batch(RBatcher, RGenRequest, models[arch], placed,
                                             policy, inputs["batcher"]["full"])}
    # The reference's batcher fails on a mesh for the ragged wave of 2 rows
    # (ROADMAP Queue 3): its tokens come from one device.
    out["batcher"]["ragged"] = _ref_batch(RBatcher, RGenRequest, models[arch], raw[arch],
                                          policy, inputs["batcher"]["ragged"])
    return out


def _ref_batch(batcher_cls, request_cls, model, params, policy, requests):
    b = batcher_cls(model, params, slots=4, max_len=64, policy=policy)
    for uid, prompt, new in requests:
        b.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=new))
    return {r.uid: np.asarray(r.tokens) for r in b.run()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, reference):
    """Run the 8-rank world once; returns each rank's results."""
    workdir = tmp_path_factory.mktemp("lm_mesh_world")
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


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,policy", SERVE_CASES, ids=[f"{a}-{p}" for a, p in SERVE_CASES])
def test_lm_server_on_mesh_matches_reference_and_one_device(world, reference, arch, policy,
                                                            mesh_name):
    got = _scenario(world, f"{mesh_name}/{arch}/{policy}")
    want = reference["serve"][(arch, policy)]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["tokens"], got["off_tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    np.testing.assert_allclose(got["logits"], got["off_logits"], **TOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,policy", SERVE_CASES, ids=[f"{a}-{p}" for a, p in SERVE_CASES])
def test_cache_keeps_the_spec_layout(world, arch, policy, mesh_name):
    """The grown cache is laid out by ``cache_spec(policy)`` (fitted) and a
    decode step leaves every tensor of it in that layout."""
    got = _scenario(world, f"{mesh_name}/{arch}/{policy}")
    assert got["grown"] == got["spec_layout"]
    assert got["kept"] == got["spec_layout"]


def test_gqa_cache_shards_the_sequence_where_heads_do_not_divide(world):
    """mistral's smoke config has 2 KV heads: heads over the 2-way model axis
    of (4, 2), the sequence over the 4-way one of (2, 4) (``Shard(2)`` of
    the (L, B, T, Hk, Dh) cache), as ``kv_cache_spec`` adapts."""
    heads = _scenario(world, "4x2/mistral-nemo-12b/tp")["kept"][0]
    seq = _scenario(world, "2x4/mistral-nemo-12b/tp")["kept"][0]
    assert heads == "(Shard(dim=1), Shard(dim=3))"
    assert seq == "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("case", list(BATCHER))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_continuous_batcher_on_mesh_matches_reference(world, reference, mesh_name, case):
    """Two full waves against the reference's mesh batcher; a full wave and
    a wave of 2 rows (which the 4 data ranks do not divide: the port
    replicates its batch) against the reference's one-device batcher."""
    got = _scenario(world, f"{mesh_name}/batcher/{case}")
    want_all = reference["batcher"][case]
    assert set(got["tokens"]) == set(want_all)
    for uid, want in want_all.items():
        np.testing.assert_array_equal(got["tokens"][uid], want)
        np.testing.assert_array_equal(got["off_tokens"][uid], want)


def test_reference_batcher_fails_on_a_ragged_wave():
    """The fault recorded in ROADMAP Queue 3: the reference's
    ``ContinuousBatcher`` on the (4, 2) mesh raises inside JAX's sharding
    code for a wave of 2 rows (its one-device run and the port's mesh run
    serve it)."""
    import jax
    from jax.sharding import NamedSharding

    from repro import configs as r_configs
    from repro.launch.mesh import make_mesh as r_make_mesh
    from repro.launch.mesh import set_mesh as r_set_mesh
    from repro.models import get_model as r_get_model
    from repro.serving.batching import ContinuousBatcher as RBatcher
    from repro.serving.batching import GenRequest as RGenRequest
    from repro.sharding.policy import TP_POLICY as R_TP
    from repro.sharding.utils import fit_specs as r_fit_specs

    cfg = r_configs.get_smoke_config("mistral-nemo-12b")
    model = r_get_model(cfg)
    raw = jax.jit(model.init)(jax.random.PRNGKey(0))
    mesh = r_make_mesh((4, 2), ("data", "model"))
    with r_set_mesh(mesh):
        spec = r_fit_specs(raw, model.param_specs(R_TP), mesh)
        placed = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), raw, spec)
        with pytest.raises(KeyError):
            _ref_batch(RBatcher, RGenRequest, model, placed, R_TP,
                       _batcher_requests(cfg.raw_vocab_size, "ragged")[4:])


def test_collectives_side_by_side(world, reference):
    """Per-kind collective bytes of one prefill and one decode step on the
    (4, 2) mesh: each rank's own (``CollectiveRecorder``) beside XLA's
    (``collective_breakdown``).  Printed, not gated, but for this: a
    sharded model communicates, and only through the kinds the recorder
    names."""
    for arch, policy in SERVE_CASES:
        got = _scenario(world, f"4x2/{arch}/{policy}")["collectives"]
        want = reference["serve"][(arch, policy)]["collectives"]
        for step in ("prefill", "decode"):
            port_bytes, counts = got[step]
            print(f"{arch} {policy} {step}: port rank 0 {port_bytes} (counts {counts}) | "
                  f"reference {want[step]}")
            assert sum(port_bytes.values()) > 0, (arch, policy, step)
            assert set(port_bytes) <= {"all-gather", "all-reduce", "reduce-scatter",
                                       "all-to-all", "collective-permute", "other"}


def test_ranks_agree(world):
    """Every rank served the same tokens and logits in lockstep."""
    for rank in range(1, WORLD):
        for name in SCENARIOS:
            a, b = _scenario(world, name, 0), _scenario(world, name, rank)
            for key in ("tokens", "logits"):
                if key in a:
                    if isinstance(a[key], dict):
                        assert all(np.array_equal(a[key][u], b[key][u]) for u in a[key])
                    else:
                        assert np.array_equal(a[key], b[key]), (rank, name, key)


def test_children_import_neither_jax_nor_the_reference(world):
    assert all(rank["forbidden_imports"] == [] for rank in world)


def test_zz_no_process_group_in_pytest_and_no_child_left():
    """Runs last in this file: the world lived in its children only."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert all(p.poll() is not None for p in _CHILDREN)


if __name__ == "__main__":
    _child_main(int(sys.argv[1]), Path(sys.argv[2]))
