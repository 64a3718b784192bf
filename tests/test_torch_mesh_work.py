"""Each rank of a mesh does only its share of a step's work.

The port's step on a mesh is counted per rank on ``meta`` tensors
(``repro_torch.launch.op_cost``) in fake worlds, as the dry run counts it:

* at smoke width on a (2, 4) ``(data, model)`` world of 8 ranks, for
  mistral-nemo-12b (8 query heads over 2 KV heads: ranks share a KV
  head), granite-34b (MQA), chameleon-34b, mamba2-780m, whisper-medium,
  qwen2-moe-a2.7b and zamba2-2.7b at a train and a prefill shape, one
  rank's FLOPs times 8 are at most 1.10 times the same step's FLOPs in a
  world of one on a (1, 1) mesh; in the train step no rank allocates a
  tensor of the logits' shape wider than its own rows and its own slice of
  the vocabulary, (B / data) S (V / model) fp32 elements at most, nor any
  tensor with the whole vocabulary as its last dimension; and in the
  prefill no single allocation on a rank is larger than its share (over
  ``data``) of the world of one's largest, and doubling the depth raises a
  rank's peak by no more than its shards of the added layers' cache in
  ``cache_spec``'s layout;
* at full scale on the 16 x 16 production mesh (rank 0 of 256), the dry
  run's ``hlo_flops`` of mistral-nemo-12b ``train_4k`` and ``prefill_32k``,
  granite-34b, mamba2-780m and zamba2-2.7b ``prefill_32k`` are at most
  1.10 times the larger of the world-of-one count and the reference's
  ``hlo_flops`` (``repro.launch.dryrun``, 512 forced host devices, under
  the same policy), and each prefill's peak a rank at most 1.5 times the
  reference's ``peak_memory_per_device``;
* each rank moves only its share over the mesh: at smoke width on the
  (2, 4) world a decode step over a cache of 256 slots — mistral's, which
  shards the sequence, at batch 8 and 1, and zamba2's, which shards its KV
  heads, at batch 1 — issues no collective larger than one token's widest
  activation row of a rank's batch rows in fp32 (nothing the size of the
  cache or the scores moves), and a mamba2 train step all-gathers no more
  than ``gathered_einsum``'s B and C, the loss's row maxima and the
  gradients of the replicated parameters read per channel or head; at full
  scale mistral-nemo-12b ``decode_32k`` and zamba2-2.7b ``long_500k``
  move at most 1.5 times the reference's collective bytes a device
  (``coll_bytes``);
* a head split that would hand a rank query heads of two KV groups without
  the whole of either raises ``ValueError``.

The fake worlds run in one child process, this file run as a script
(``python tests/test_torch_mesh_work.py OUT``; no JAX, no reference
package); the reference's dry runs in another, started beside it.
"""
import dataclasses
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
         "qwen2-moe-a2.7b", "zamba2-2.7b")
SHAPES = {"train": ("t", 64, 8, "train"), "prefill": ("p", 64, 8, "prefill")}
SLACK = 1.10
#: Full-scale pairs, and whether the world-of-one count is taken too (the
#: reference's count alone bounds the prefills).
FULL = {("mistral-nemo-12b", "train_4k"): True, ("granite-34b", "prefill_32k"): False,
        ("mamba2-780m", "prefill_32k"): False, ("mistral-nemo-12b", "prefill_32k"): False,
        ("zamba2-2.7b", "prefill_32k"): False, ("mistral-nemo-12b", "decode_32k"): False,
        ("zamba2-2.7b", "long_500k"): False}
#: A rank's peak at full scale at most this many times the reference's
#: ``peak_memory_per_device`` (the prefill pairs of ``FULL``).
PEAK_SLACK = 1.5
PREFILL_PEAKS = [pair for pair in FULL if pair[1].startswith("prefill")]
#: A rank's collective bytes at full scale at most this many times the
#: reference's ``coll_bytes`` a device: the decode over a sequence-split
#: cache and the batch-1 decode over a head-split one.
COLL_SLACK = 1.5
COLL_PAIRS = [("mistral-nemo-12b", "decode_32k"), ("zamba2-2.7b", "long_500k")]
#: Smoke decode steps on the (2, 4) world: (arch, batch) over a cache of
#: DECODE_SLOTS slots.  mistral's 2 KV heads do not divide the 4-way model
#: axis (its cache shards the sequence); zamba2's 4 do (they shard).
DECODES = (("mistral-nemo-12b", 8), ("mistral-nemo-12b", 1), ("zamba2-2.7b", 1))
DECODE_SLOTS = 256
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
        biggest = 0  # the largest single allocation of any shape
        full_vocab: list = []

        def _track(self, ins, out):
            shared = {op_cost._storage_key(t) for t in ins}
            for t in tree_leaves(out):
                if op_cost._storage_key(t) in shared:
                    continue
                self.biggest = max(self.biggest, t.untyped_storage().nbytes())
                if t.dim() != 3:
                    continue
                if t.shape[-1] == vocab_local:
                    self.largest = max(self.largest, t.untyped_storage().nbytes())
                if t.shape[-1] == vocab and vocab != vocab_local:
                    self.full_vocab = self.full_vocab + [tuple(t.shape)]
            super()._track(ins, out)

    return Watch()


def _cache_share(plan, cache) -> int:
    """The bytes of a rank's shards of a prefill's ``cache`` laid out by the
    model's ``cache_spec`` (fitted to each tensor's shape)."""
    from repro_torch.models.cache import cache_leaves, map_cache
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.utils import fit_spec, local_extent, placements

    mesh = cache_leaves(cache)[0].device_mesh

    def share(t, sp):
        pls = placements(fit_spec(tuple(t.shape), sp, mesh), mesh)
        n = 1
        for _, size in local_extent(t.shape, pls, mesh):
            n *= size
        return n * t.element_size()

    return sum(cache_leaves(map_cache(share, cache, get_model(plan.cfg).cache_spec(plan.policy))))


def _count(plan, vocab_local: int, vocab: int) -> dict:
    from repro_torch.sharding.collectives import CollectiveRecorder

    counter, rec = _watch(vocab_local, vocab), CollectiveRecorder()
    with rec, counter:
        out = plan.step_fn(*plan.args)
    row = {"flops": counter.flops, "largest": counter.largest,
           "full_vocab": counter.full_vocab, "peak": counter.peak_bytes,
           "biggest": counter.biggest, "all_gather": rec.bytes.get("all-gather", 0.0),
           "largest_collective": rec.largest}
    if plan.kind == "prefill":
        row["cache_share"] = _cache_share(plan, out[1])
    return row


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
                    if key == "mesh":  # the prefill again at twice the depth
                        deep = dataclasses.replace(cfg, num_layers=2 * cfg.num_layers)
                        plan = make_plan(deep, InputShape(*SHAPES["prefill"]), mesh, "tp")
                        out[key][f"{arch}/prefill/deep"] = _count(
                            plan, cfg.vocab_size // model_ways, cfg.vocab_size)
                if key == "mesh":
                    for arch, batch in DECODES:
                        cfg = get_smoke_config(arch)
                        plan = make_plan(cfg, InputShape("d", DECODE_SLOTS, batch, "decode"),
                                         mesh, "tp")
                        kv = getattr(plan.args[2], "kv", plan.args[2])  # a hybrid's KV part
                        out[key][f"{arch}/decode/{batch}"] = {
                            **_count(plan, cfg.vocab_size // model_ways, cfg.vocab_size),
                            "placements": [str(pl) for pl in kv.k.placements]}
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
               "hlo_flops": res.get("hlo_flops"), "one": None,
               "peak": res.get("peak_memory_per_device"), "coll": res.get("coll_bytes")}
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
                               "peak": res.get("peak_memory_per_device"),
                               "coll": res.get("coll_bytes"), "error": res.get("error")}
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_holds_only_its_share(work, arch):
    """A prefill on the (2, 4) world: no single allocation on a rank is
    larger than its share of the largest one in the world of one (every
    activation splits its batch over ``data`` at least), and doubling the
    depth raises a rank's peak by no more than its shards of the added
    layers' cache (the cache is allocated once in its layout; each layer's
    conv input, K and V are freed with the layer)."""
    rank, deep = work["mesh"][f"{arch}/prefill"], work["mesh"][f"{arch}/prefill/deep"]
    share = work["one"][f"{arch}/prefill"]["biggest"] // MESH[0]
    assert 0 < rank["biggest"] <= share, (rank["biggest"], share)
    grown, cache = deep["peak"] - rank["peak"], deep["cache_share"] - rank["cache_share"]
    assert 0 < cache and grown <= cache, (grown, cache)


@pytest.mark.parametrize("arch,shape", PREFILL_PEAKS)
def test_full_scale_prefill_peak_within_the_reference(work, arch, shape):
    key = f"{arch}/{shape}"
    port, ref = work["full"][key], work["ref"][key]
    assert port["status"] == "ok", port["error"]
    assert ref["status"] == "ok", ref["error"]
    assert 0 < port["peak"] <= PEAK_SLACK * ref["peak"], (port["peak"] / ref["peak"], port, ref)


def _row_width(cfg) -> int:
    """The widest activation row of one token in a decode step: the
    residual stream, the attention's heads, or Mamba2's conv channels."""
    conv = cfg.ssm_d_inner + 2 * cfg.ssm_state if cfg.family in ("ssm", "hybrid") else 0
    return max(cfg.d_model, cfg.n_heads * cfg.head_dim, conv)


@pytest.mark.parametrize("arch,batch", DECODES)
def test_decode_moves_no_cache(work, arch, batch):
    """A decode step on the (2, 4) world issues no collective larger than
    one token's widest activation row of a rank's batch rows in fp32: the
    scores are reduced where the cache's slots lie (mistral, its sequence
    split) and the query heads follow the cache's head split (zamba2 at
    batch 1), so nothing that grows with the cache's length moves."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    row = work["mesh"][f"{arch}/decode/{batch}"]
    split = "S(2)" if arch == "mistral-nemo-12b" else "S(3)"
    assert split in row["placements"], row["placements"]
    rows = batch // MESH[0] if batch % MESH[0] == 0 else batch
    bound = rows * _row_width(cfg) * 4
    assert 0 < row["largest_collective"] <= bound, (row["largest_collective"], bound)


def test_mamba2_train_gathers_only_b_and_c(work):
    """A mamba2 train step on the (2, 4) world all-gathers no more than
    ``gathered_einsum``'s B and C (each rank's rows, S x N, once per layer
    and forward pass), the loss's row maxima (one fp32 value per row and
    vocabulary shard) and the gradients of the replicated parameters that
    each rank reads only its own channels or heads of (the conv's kernel,
    the gated norm's scale, ``dt_bias``, ``a_log``, ``d_skip``):
    ``d_inner`` stays split through the conv, the gated norm and their
    backwards."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("mamba2-780m")
    _, seq, batch, _ = SHAPES["train"]
    rows = batch // MESH[0]
    passes = 2 if cfg.remat else 1
    b_and_c = (cfg.num_layers * passes * 2 * rows * seq * cfg.ssm_state
               * cfg.activation_dtype().itemsize)
    maxima = rows * seq * MESH[1] * 4
    di = cfg.ssm_d_inner
    grads = (cfg.num_layers * (cfg.ssm_conv_width * di + di + 3 * cfg.ssm_n_heads)
             * cfg.params_dtype().itemsize)
    got = work["mesh"]["mamba2-780m/train"]["all_gather"]
    assert 0 < got <= b_and_c + maxima + grads, (got, b_and_c, maxima, grads)


@pytest.mark.parametrize("arch,shape", COLL_PAIRS)
def test_full_scale_collectives_within_the_reference(work, arch, shape):
    key = f"{arch}/{shape}"
    port, ref = work["full"][key], work["ref"][key]
    assert port["status"] == "ok", port["error"]
    assert ref["status"] == "ok", ref["error"]
    assert 0 < port["coll"] <= COLL_SLACK * ref["coll"], (port["coll"] / ref["coll"], port, ref)


def test_a_straddling_head_split_raises(work):
    hq, hk = STRADDLE
    msg = work["straddle"]
    assert msg is not None
    assert f"{hq} query heads over {hk} KV heads split {MESH[1]} ways" in msg
