"""Each rank of a mesh does only its share of a step's work.

The port's step on a mesh is counted per rank on ``meta`` tensors
(``repro_torch.launch.op_cost``) in fake worlds, as the dry run counts it:

* at smoke width on a (2, 4) ``(data, model)`` world of 8 ranks, for
  mistral-nemo-12b (8 query heads over 2 KV heads: ranks share a KV
  head), granite-34b (MQA), chameleon-34b, mamba2-780m, whisper-medium
  and qwen2-moe-a2.7b at a train and a prefill shape, one rank's FLOPs
  times 8 are at most 1.10 times the same step's FLOPs in a world of one
  on a (1, 1) mesh; and in the train step no rank allocates a tensor of the
  logits' shape wider than its own rows and its own slice of the
  vocabulary, (B / data) S (V / model) fp32 elements at most, nor any
  tensor with the whole vocabulary as its last dimension;
* at full scale on the 16 x 16 production mesh (rank 0 of 256), the dry
  run's ``hlo_flops`` of mistral-nemo-12b ``train_4k`` and granite-34b
  ``prefill_32k`` are at most 1.10 times the larger of the world-of-one
  count and the reference's ``hlo_flops`` (``repro.launch.dryrun``, 512
  forced host devices, under the same policy);
* a head split that would hand a rank query heads of two KV groups without
  the whole of either raises ``ValueError``.

The fake worlds run in one child process, this file run as a script
(``python tests/test_torch_mesh_work.py OUT``; no JAX, no reference
package); the reference's dry runs in another, started beside it.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD_SECONDS = 300
MESH = (2, 4)
ARCHS = ("mistral-nemo-12b", "granite-34b", "chameleon-34b", "mamba2-780m", "whisper-medium",
         "qwen2-moe-a2.7b")
SHAPES = {"train": ("t", 64, 8, "train"), "prefill": ("p", 64, 8, "prefill")}
SLACK = 1.10
#: Full-scale pairs, and whether the world-of-one count is taken too (the
#: reference's count alone bounds granite-34b's prefill).
FULL = {("mistral-nemo-12b", "train_4k"): True, ("granite-34b", "prefill_32k"): False}
STRADDLE = (24, 6)  # Hq, Hk: 6 query heads a rank over groups of 4


# ==========================================================================
# The child: the fake worlds (no JAX, no reference package)
# ==========================================================================

def _watch(vocab_local: int, vocab: int):
    """An ``OpCounter`` that also keeps the largest logits-shaped tensor a
    rank allocates (3-D, its own vocabulary slice last) and the shape of
    any 3-D tensor with the whole vocabulary last."""
    from repro_torch._device import tree_leaves
    from repro_torch.launch import op_cost

    class Watch(op_cost.OpCounter):
        largest = 0
        full_vocab: list = []

        def _track(self, ins, out):
            shared = {op_cost._storage_key(t) for t in ins}
            for t in tree_leaves(out):
                if t.dim() != 3 or op_cost._storage_key(t) in shared:
                    continue
                if t.shape[-1] == vocab_local:
                    self.largest = max(self.largest, t.untyped_storage().nbytes())
                if t.shape[-1] == vocab and vocab != vocab_local:
                    self.full_vocab = self.full_vocab + [tuple(t.shape)]
            super()._track(ins, out)

    return Watch()


def _count(plan, vocab_local: int, vocab: int) -> dict:
    counter = _watch(vocab_local, vocab)
    with counter:
        plan.step_fn(*plan.args)
    return {"flops": counter.flops, "largest": counter.largest,
            "full_vocab": counter.full_vocab}


def _child(out_dir: str) -> None:
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.ops import mesh_heads
    from repro_torch.launch.dryrun import fake_world, run_one
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.launch.specs import make_plan
    from repro_torch.models.config import InputShape, get_shape

    torch.set_num_threads(1)
    out = {"mesh": {}, "one": {}, "full": {}, "seconds": {}}
    t0 = time.perf_counter()
    for key, world, shape in (("mesh", 8, MESH), ("one", 1, (1, 1))):
        model_ways = shape[1]
        with fake_world(world):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            with set_mesh(mesh):
                for arch in ARCHS:
                    cfg = get_smoke_config(arch)
                    for kind, sh in SHAPES.items():
                        plan = make_plan(cfg, InputShape(*sh), mesh, "tp")
                        out[key][f"{arch}/{kind}"] = _count(
                            plan, cfg.vocab_size // model_ways, cfg.vocab_size)
                if key == "mesh":
                    hq, hk = STRADDLE
                    q = DTensor.from_local(torch.empty((4, 1, hq // 4, 2), device="meta"), mesh,
                                           [Shard(0), Shard(2)], run_check=False)
                    try:
                        mesh_heads(q, hk)
                        out["straddle"] = None
                    except ValueError as err:
                        out["straddle"] = str(err)
    out["seconds"]["smoke"] = time.perf_counter() - t0
    for (arch, shape), one in FULL.items():
        t0 = time.perf_counter()
        res = run_one(arch, shape, "single", "tp", None, verbose=False)
        row = {"status": res["status"], "error": res.get("error"),
               "hlo_flops": res.get("hlo_flops"), "one": None}
        if one:
            with fake_world(1):
                mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
                with set_mesh(mesh):
                    cfg = get_config(arch)
                    plan = make_plan(cfg, get_shape(shape), mesh, "tp")
                    row["one"] = _count(plan, cfg.vocab_size, cfg.vocab_size)["flops"]
        out["full"][f"{arch}/{shape}"] = row
        out["seconds"][f"{arch}/{shape}"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, "work.json"), "w") as fh:
        json.dump(out, fh)


_REFERENCE = """
import json, sys
from repro.launch.dryrun import run_one
out = {}
for arch, shape in json.loads(sys.argv[2]):
    res = run_one(arch, shape, "single", "tp", None, verbose=False)
    out[arch + "/" + shape] = {"status": res["status"], "hlo_flops": res.get("hlo_flops"),
                               "error": res.get("error")}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The port's counts (the child) and the reference's full-scale dry runs
    (a JAX process of 512 forced host devices), run side by side."""
    out = tmp_path_factory.mktemp("work")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=512")
    pairs = json.dumps(list(FULL))
    procs = [subprocess.Popen([sys.executable, __file__, str(out)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out / "ref.json"), pairs],
                              env=ref_env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    try:
        results = [p.communicate(timeout=WORLD_SECONDS) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    got = json.loads((out / "work.json").read_text())
    got["ref"] = json.loads((out / "ref.json").read_text())
    return got


if __name__ == "__main__":
    _child(sys.argv[1])
    sys.exit(0)


# ==========================================================================
# The tests
# ==========================================================================

CASES = [(arch, kind) for arch in ARCHS for kind in SHAPES]


@pytest.mark.parametrize("arch,kind", CASES)
def test_each_rank_does_its_share(work, arch, kind):
    ranks = MESH[0] * MESH[1]
    rank = work["mesh"][f"{arch}/{kind}"]["flops"]
    one = work["one"][f"{arch}/{kind}"]["flops"]
    assert rank > 0 and one > 0
    assert rank * ranks <= SLACK * one, (rank * ranks / one, rank, one)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_loss_holds_only_its_vocabulary_slice(work, arch):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    _, seq, batch, _ = SHAPES["train"]
    row = work["mesh"][f"{arch}/train"]
    bound = (batch // MESH[0]) * seq * (cfg.vocab_size // MESH[1]) * 4
    assert row["full_vocab"] == []
    assert 0 < row["largest"] <= bound, (row["largest"], bound)


@pytest.mark.parametrize("arch,shape", list(FULL))
def test_full_scale_flops_within_the_reference(work, arch, shape):
    key = f"{arch}/{shape}"
    port, ref = work["full"][key], work["ref"][key]
    assert port["status"] == "ok", port["error"]
    assert ref["status"] == "ok", ref["error"]
    cap = max(ref["hlo_flops"], port["one"] or 0.0)
    assert port["hlo_flops"] <= SLACK * cap, (port["hlo_flops"] / cap, port, ref)


def test_a_straddling_head_split_raises(work):
    hq, hk = STRADDLE
    msg = work["straddle"]
    assert msg is not None
    assert f"{hq} query heads over {hk} KV heads split {MESH[1]} ways" in msg
