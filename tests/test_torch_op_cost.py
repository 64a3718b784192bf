"""The port's per-rank op counter (``repro_torch.launch.op_cost``), the
counterpart of ``repro.launch.hlo_cost``, and the hand kernels' counts.

The four HLO tests of ``tests/test_sharding_and_hlo.py`` re-pointed: a
Python loop of 7 ``tanh(x @ w)`` counts exactly 2 * 64^3 * 7 FLOPs (the
reference's scan and its unrolled loop); one product exactly 2 * 32 * 48 *
16; ``tanh(x) * 2``'s bytes lie within the reference's bounds with no
collective bytes; and on a 2-rank world the ``coll_*`` keys equal
:class:`~repro_torch.sharding.collectives.CollectiveRecorder`'s own
breakdown, whose ``largest`` is its largest single collective.  Then the
two traps of counting FLOPs under ``DTensor``: a (256 x 4096) @ (4096 x
8192) product on a (16, 16) mesh counts one rank's
2 * 256 * 4096 * 8192 / 256 FLOPs on its first call (when DTensor's
sharding propagation also runs the op on global-shape fake tensors) and on
its second, where ``FlopCounterMode`` counts the global product.  Each hand
kernel (Pearson, the flash forward and backward, the SSD forward and
backward) counts one launch of its ``roofline`` formula on the CPU (the
plain versions, whose own ops are not counted) and on ``meta``, with equal
results; a smoke mistral forward counts exactly a closed form.

The fake worlds (``repro_torch.launch.dryrun.fake_world``: 2 ranks, then
256) run in one child process, this file run as a script (``python
tests/test_torch_op_cost.py OUT``), with its own time limit: no process
group is ever made in the pytest process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD_SECONDS = 120


# ==========================================================================
# The child: the fake worlds (no JAX, no reference package)
# ==========================================================================

def _child(out_path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import analyze_step
    from repro_torch.sharding.collectives import CollectiveRecorder

    torch.set_num_threads(1)
    out = {}
    # The reference's collective test: x replicated, w split over "model",
    # the product gathered whole.
    with fake_world(2):
        mesh = make_mesh((2,), ("model",), device="cpu")
        x = distribute_tensor(torch.empty(16, 32, device="meta"), mesh, [Replicate()])
        w = distribute_tensor(torch.empty(32, 64, device="meta"), mesh, [Shard(1)])

        def f():
            return (x @ w).redistribute(mesh, [Replicate()])

        acc = analyze_step(f)
        with CollectiveRecorder() as rec:
            f()
        with CollectiveRecorder() as two:  # a (16, 64) and a (2, 64) all-gather
            f()
            (x[:2] @ w).redistribute(mesh, [Replicate()])
        out["two_ranks"] = {"acc": {k: v for k, v in acc.items()
                                    if k.startswith("coll") and k != "collective_counts"},
                            "recorder": rec.breakdown(),
                            "two": (two.breakdown(), two.counts, two.largest)}
    out["group_after_two_ranks"] = dist.is_initialized()
    # The traps: a (16, 16) mesh of 256 ranks.
    with fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        x = distribute_tensor(torch.empty(256, 4096, device="meta"), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(4096, 8192, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        out["product"] = [analyze_step(lambda: x @ w)["flops"] for _ in range(2)]
        out["local_shape"] = list((x @ w).to_local().shape)
        with FlopCounterMode(display=False) as fc:
            x @ w
        out["flop_counter_mode"] = fc.get_total_flops()
        with fake_world_refused() as refused:
            with fake_world(8):
                pass
        out["nested_refused"] = refused["raised"]
    out["group_after"] = dist.is_initialized()
    with open(out_path, "w") as fh:
        json.dump(out, fh)


class fake_world_refused:
    """Whether the body raised ``RuntimeError`` (a fake world refusing to
    start inside another)."""

    def __enter__(self):
        self.state = {"raised": False}
        return self.state

    def __exit__(self, kind, value, tb):
        self.state["raised"] = kind is RuntimeError
        return kind is RuntimeError


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("op_cost") / "world.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, __file__, str(out)], capture_output=True, text=True,
                         env=env, timeout=WORLD_SECONDS, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


# ==========================================================================
# The tests
# ==========================================================================

from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_cost import OpCounter, active_counter, analyze_step  # noqa: E402


def test_op_cost_counts_a_loop_of_products_exactly():
    """The reference's scan test: 7 ``tanh(x @ w)`` count 2 * 64^3 * 7."""
    x, w = torch.randn(64, 64), torch.randn(64, 64)

    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    assert analyze_step(f, x, w)["flops"] == 2 * 64**3 * 7


def test_op_cost_counts_dot_flops_exactly():
    x, w = torch.randn(32, 48), torch.randn(48, 16)
    assert analyze_step(lambda x, w: x @ w, x, w)["flops"] == 2 * 32 * 48 * 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_cost_bytes_positive_and_bounded(device):
    x = torch.empty(256, 256, device=device)
    acc = analyze_step(lambda x: torch.tanh(x) * 2.0, x)
    nbytes = 256 * 256 * 4
    assert nbytes <= acc["bytes"] <= 6 * nbytes  # in + out (+ copies)
    assert acc["collective_bytes"] == 0.0
    assert acc["flops"] == 0.0


def test_views_and_allocations_are_free():
    x = torch.empty(64, 64, device="meta")
    acc = analyze_step(lambda x: (x.view(-1), x.t(), x[1:], x.detach(), torch.empty_like(x),
                                  x.to("meta")), x)
    assert acc["bytes"] == 0.0 and acc["flops"] == 0.0


def test_peak_bytes_follow_the_live_tensors():
    """Two 1 MB temporaries at most at once, each freed in turn."""
    x = torch.empty(256, 1024, device="meta")

    def f(x):
        for _ in range(5):
            y = x * 2
            z = torch.tanh(y)
            del y, z
        return None

    acc = analyze_step(f, x)
    assert acc["peak_bytes"] == 2 * x.numel() * 4
    assert acc["output_bytes"] == 0


def test_collective_breakdown_matches_the_recorder(world):
    acc, rec = world["two_ranks"]["acc"], world["two_ranks"]["recorder"]
    assert rec and sum(rec.values()) > 0
    assert acc["collective_bytes"] == sum(rec.values())
    for kind, v in rec.items():
        assert acc[f"coll_{kind}"] == v
    for kind in roofline.COLLECTIVE_KINDS:
        assert acc[f"coll_{kind}"] == rec.get(kind, 0.0)


def test_recorder_keeps_the_largest_single_collective(world):
    """Two all-gathers of fp32 (16, 64) and (2, 64) results on a rank:
    their bytes add up, and ``largest`` is the first one's alone."""
    kinds, counts, largest = world["two_ranks"]["two"]
    assert kinds == {"all-gather": (16 + 2) * 64 * 4}
    assert counts == {"all-gather": 2}
    assert largest == 16 * 64 * 4


def test_sharded_product_counts_one_ranks_flops_on_every_call(world):
    """Trap 2: the first call's sharding propagation runs on fake tensors
    and is not counted; the count is one rank's, 67,108,864, both times."""
    per_rank = 2 * 256 * 4096 * 8192 // 256
    assert world["product"] == [per_rank, per_rank]
    assert world["local_shape"] == [16, 512]


def test_flop_counter_mode_counts_the_global_product(world):
    """Trap 1: why the counter is not ``FlopCounterMode``."""
    assert world["flop_counter_mode"] == 2 * 256 * 4096 * 8192


def test_fake_world_refuses_to_nest_and_cleans_up(world):
    assert world["nested_refused"] is True
    assert world["group_after_two_ranks"] is False and world["group_after"] is False


# -------------------------------------------------------------- hand kernels

def _flash_call(device, dtype, b=2, s=40, t=40, hq=4, hk=2, d=32, causal=True, window=None):
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(device=device, dtype=dtype).requires_grad_()
               for shape in ((b, s, hq, d), (b, t, hk, d), (b, t, hk, d)))

    def step():
        o = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        o.float().sum().backward()
        return o

    return step


def _flat_flash_call(device, dtype):
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator().manual_seed(1)
    q = torch.randn(6, 33, 16, generator=g).to(device=device, dtype=dtype)
    k = torch.randn(3, 50, 16, generator=g).to(device=device, dtype=dtype)
    v = torch.randn(3, 50, 16, generator=g).to(device=device, dtype=dtype)
    return lambda: flash_attention(q, k, v, causal=False, window=20)


def _ssd_call(device, dtype, b=2, s=64, h=3, p=32, n=16, chunk=32):
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(2)
    x = torch.randn(b, s, h, p, generator=g).to(device=device, dtype=dtype).requires_grad_()
    dt = torch.rand(b, s, h, generator=g).to(device).requires_grad_()
    a = (-torch.rand(h, generator=g)).to(device).requires_grad_()
    bb = torch.randn(b, s, n, generator=g).to(device=device, dtype=dtype).requires_grad_()
    cc = torch.randn(b, s, n, generator=g).to(device=device, dtype=dtype).requires_grad_()

    def step():
        y, fin = ops.ssd_scan(x, dt, a, bb, cc, chunk)
        (y.float().sum() + fin.sum()).backward()
        return y

    return step


def _pearson_call(device):
    from repro_torch.kernels.pearson_affinity import pearson_dissimilarity

    z = torch.randn(37, 300, generator=torch.Generator().manual_seed(3)).to(device)
    return lambda: pearson_dissimilarity(z)


KERNEL_CASES = {
    "pearson": (_pearson_call, {"pearson_gram": roofline.pearson_work(37, 300)}),
    "flash": (lambda dev: _flash_call(dev, torch.float32), {
        "flash_attention": roofline.flash_work(2, 40, 40, 4, 2, 32, torch.float32, True, None),
        "flash_attention_bwd": roofline.flash_bwd_work(2, 40, 40, 4, 2, 32, torch.float32,
                                                       True, None)}),
    "flash_window_bf16": (lambda dev: _flash_call(dev, torch.bfloat16, s=70, t=70, hq=2, hk=2,
                                                  d=16, causal=True, window=24), {
        "flash_attention": roofline.flash_work(2, 70, 70, 2, 2, 16, torch.bfloat16, True, 24),
        "flash_attention_bwd": roofline.flash_bwd_work(2, 70, 70, 2, 2, 16, torch.bfloat16,
                                                       True, 24)}),
    "flash_flat": (lambda dev: _flat_flash_call(dev, torch.float32), {
        "flash_attention": roofline.flash_work(3, 33, 50, 2, 1, 16, torch.float32, False, 20)}),
    "ssd": (lambda dev: _ssd_call(dev, torch.float32), {
        "ssd_scan": roofline.ssd_work(2, 64, 3, 32, 16, 32, torch.float32),
        "ssd_scan_bwd": roofline.ssd_bwd_work(2, 64, 3, 32, 16, 32, torch.float32, True)}),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_each_kernel_counts_its_formula_once_on_cpu_and_meta(case):
    make, want = KERNEL_CASES[case]
    got = {}
    for device in ("cpu", "meta"):
        acc = analyze_step(make(device))
        got[device] = acc["kernels"]
        assert set(acc["kernels"]) == set(want), (device, acc["kernels"])
        for name, work in want.items():
            assert acc["kernels"][name] == {"launches": 1, **work}, (device, name)
    assert got["cpu"] == got["meta"]


def test_no_counter_no_cost():
    assert active_counter() is None
    with OpCounter() as c:
        assert active_counter() is c
    assert active_counter() is None


def test_counted_plain_routes_give_the_uncounted_gradients():
    """Under a counter the CPU routes take the plain backward functions
    (so the backward counts as its kernel's launch): the same gradients as
    autograd through the plain forward."""
    for make in (lambda: _flash_call("cpu", torch.float32, window=16),
                 lambda: _ssd_call("cpu", torch.float32)):
        plain = make()
        plain()
        want = [t.grad.clone() for t in _grad_inputs(plain)]
        counted = make()
        analyze_step(counted)
        got = [t.grad for t in _grad_inputs(counted)]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def _grad_inputs(step):
    """The leaf tensors a ``_flash_call`` / ``_ssd_call`` closure captured."""
    cells = [c.cell_contents for c in step.__closure__ or ()]
    return [t for t in cells if isinstance(t, torch.Tensor) and t.requires_grad]


def test_meta_paths_keep_the_kernels_checks():
    from repro_torch.kernels import ops
    from repro_torch.kernels.pearson_affinity import pearson_dissimilarity

    meta = dict(device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention_bhsd(*(torch.empty(1, 8, 2, 48, **meta) for _ in range(3)))
    with pytest.raises(TypeError):
        ops.flash_attention_bhsd(*(torch.empty(1, 8, 2, 32, dtype=torch.float16, **meta)
                                   for _ in range(3)))
    with pytest.raises(ValueError, match="without any allowed key"):
        ops.flash_attention_bhsd(torch.empty(1, 40, 2, 32, **meta),
                                 torch.empty(1, 8, 2, 32, **meta),
                                 torch.empty(1, 8, 2, 32, **meta), causal=False, window=4)
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ops.ssd_scan(torch.empty(1, 8, 2, 24, **meta), torch.empty(1, 8, 2, **meta),
                     torch.empty(2, **meta), torch.empty(1, 8, 16, **meta),
                     torch.empty(1, 8, 16, **meta), 8)
    with pytest.raises(NotImplementedError):
        pearson_dissimilarity(torch.empty(4, 8, requires_grad=True, **meta))


# -------------------------------------------------------- a smoke forward

def test_smoke_mistral_forward_counts_a_closed_form():
    """Projections (Q, fused K/V, O), the fused SwiGLU MLP, the unembedding
    and the flash kernel's causal pairs: every FLOP of the forward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model

    cfg = get_smoke_config("mistral-nemo-12b")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 24
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    d, hq, hk, hd, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                           cfg.vocab_size)
    per_layer = 2 * b * s * (d * hq * hd + 2 * d * hk * hd + hq * hd * d + 2 * d * f + f * d)
    pairs = s * (s + 1) // 2
    attention = 4 * b * hq * pairs * hd
    want = cfg.num_layers * (per_layer + attention) + 2 * b * s * d * v
    with torch.no_grad():
        acc = analyze_step(model.forward, params, tokens)
    assert acc["flops"] == want
    assert acc["kernels"]["flash_attention"]["launches"] == cfg.num_layers
    assert acc["kernels"]["flash_attention"]["flops"] == cfg.num_layers * attention


if __name__ == "__main__":
    _child(sys.argv[1])
