"""The port's MoE (mixtral-8x22b, qwen2-moe-a2.7b) and VLM (chameleon-34b)
decoder families, and every new family's serving, against the JAX
package's.

The same weights (the reference's, carried over by
``params_from_reference``) and the same token ids go through both
packages at the smoke configs: ``forward`` (logits and the summed aux
loss), ``prefill`` (last logits and the cache, mixtral's 32-slot ring
included) and several ``decode_step``s; ``LMServer.generate`` on all four
new archs (whisper with its features); Antler's engine on a 2-layer MoE
backbone; the serve launcher.  Tolerances: fp32 2e-5 (the reference's own
for modules), 3e-3 for decode against forward (``tests/test_models_equiv.py``).
Greedy tokens, counters and traces are equal exactly.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.core import task_graph as r_tg
from repro.core.types import TPU_V5E as R_TPU
from repro.models import make_config as r_make_config
from repro.models import multitask as r_mt
from repro.models import registry as r_registry
from repro.models import transformer as r_tf
from repro.serving import engine as r_engine
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.core import task_graph as p_tg
from repro_torch.core.types import TPU_V5E as P_TPU
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve as p_serve
from repro_torch.models import multitask as p_mt
from repro_torch.models import registry as p_registry
from repro_torch.models import transformer as p_tf
from repro_torch.models.config import make_config as p_make_config
from repro_torch.serving import engine as p_engine

P = TP_POLICY
FP32 = dict(rtol=2e-5, atol=2e-5)
DECODE = dict(rtol=3e-3, atol=3e-3)
DECODERS = ("qwen2-moe-a2.7b", "mixtral-8x22b", "chameleon-34b")
NEW_ARCHS = DECODERS + ("whisper-medium",)
# The reference's entry points, each compiled once per input shape.
R_FORWARD = jax.jit(r_tf.forward, static_argnums=(2, 3))
R_PREFILL = jax.jit(r_tf.prefill, static_argnums=(2, 3))
R_DECODE = jax.jit(r_tf.decode_step, static_argnums=(4, 5))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(shape, seed, vocab=1000):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(port, ref, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference params, port
    params) at the smoke config, built once for the module."""
    out = {}
    for arch in NEW_ARCHS:
        rcfg, pcfg = r_configs.get_smoke_config(arch), p_configs.get_smoke_config(arch)
        rp = jax.jit(r_registry.get_model(rcfg).init)(jax.random.PRNGKey(1))
        out[arch] = (rcfg, pcfg, rp, p_mt.params_from_reference(_np_tree(rp), device="cpu"))
    return out


# --------------------------------------------------------------------------
# The decoder families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODERS)
def test_forward_prefill_decode_match_reference(models, arch):
    """40 prompt tokens: past mixtral's 32-token window, so its prefill
    rolls the cache into the ring and decode writes and reads the ring."""
    rcfg, pcfg, rp, pp = models[arch]
    toks = _tokens((2, 44), seed=2)
    ref_logits, ref_aux = R_FORWARD(rp, jnp.asarray(toks), rcfg, P)
    logits, aux = p_tf.forward(pp, toks, pcfg)
    _close(logits, ref_logits)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    assert (float(aux) > 0) == (pcfg.family == "moe")

    ref_last, ref_cache = R_PREFILL(rp, jnp.asarray(toks[:, :40]), rcfg, P)
    last, cache = p_tf.prefill(pp, toks[:, :40], pcfg)
    _close(last, ref_last)
    assert cache.capacity == (32 if arch == "mixtral-8x22b" else 40) == ref_cache.capacity
    _close(cache.k, ref_cache.k)
    _close(cache.v, ref_cache.v)

    ref_cache = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 44, 40)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 44, 40)
    for t in range(40, 44):
        ref_step, ref_cache = R_DECODE(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, cache = p_tf.decode_step(pp, toks[:, t], cache, t, pcfg)
        _close(step, ref_step)
    _close(cache.k, ref_cache.k)


def test_moe_decode_matches_forward():
    """``tests/test_models_equiv.py::test_moe_decode_matches_forward`` on the
    port: a capacity factor of 8 drops nothing, so one decode step after a
    19-token prefill equals ``forward``'s 20th position to 3e-3."""
    kw = dict(
        name="m", family="moe", num_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=0, vocab_size=300, moe_num_experts=4, moe_top_k=2,
        moe_num_shared_experts=1, moe_d_ff=96, moe_capacity_factor=8.0,
        dtype="float32", param_dtype="float32", remat=False, attn_chunk=16,
    )
    rcfg, pcfg = r_make_config(**kw), p_make_config(**kw)
    pp = p_mt.params_from_reference(
        _np_tree(jax.jit(r_tf.init, static_argnums=1)(jax.random.PRNGKey(4), rcfg)), device="cpu")
    toks = _tokens((2, 20), seed=5, vocab=300)
    full, _ = p_tf.forward(pp, toks, pcfg)
    last, cache = p_tf.prefill(pp, toks[:, :19], pcfg)
    _close(last, full[:, 18].numpy(), DECODE)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 20, 19)
    step, _ = p_tf.decode_step(pp, toks[:, 19], cache, 19, pcfg)
    _close(step, full[:, 19].numpy(), DECODE)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_arch_forward_prefill_and_decode_step(arch):
    """``tests/test_smoke_archs.py``'s forward and prefill + decode cases on
    the port's own init: shapes, no NaNs."""
    cfg = p_configs.get_smoke_config(arch)
    model = p_registry.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")

    def batch(seq):
        tokens = torch.as_tensor(_tokens((2, seq), seed=0, vocab=cfg.raw_vocab_size))
        if cfg.family == "encdec":
            feats = np.random.default_rng(1).standard_normal((2, seq, cfg.enc_inputs))
            return {"features": feats.astype(np.float32), "tokens": tokens}
        return tokens

    logits, aux = model.forward(params, batch(32))
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert not torch.isnan(logits).any() and not torch.isnan(aux).any()
    logits, cache = model.prefill(params, batch(16))
    assert logits.shape == (2, cfg.vocab_size) and not torch.isnan(logits).any()
    tok = torch.argmax(logits, dim=-1)
    cache = p_engine._grow_cache(model, cache, 17, 16)
    logits2, _ = model.decode_step(params, tok, cache, 16)
    assert logits2.shape == (2, cfg.vocab_size) and not torch.isnan(logits2).any()


@pytest.mark.parametrize("arch", DECODERS)
def test_init_draws_reference_layouts(arch):
    rcfg, pcfg = r_configs.get_smoke_config(arch), p_configs.get_smoke_config(arch)
    ref = jax.eval_shape(lambda: r_tf.init(jax.random.PRNGKey(0), rcfg))
    port = p_tf.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), port
    ) == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_server_greedy_tokens_equal_reference(models, arch):
    """Greedy tokens equal the reference server's; whisper's features go in
    (24 frames: a T_enc that is not a multiple of its 64-key chunk)."""
    rcfg, pcfg, rp, pp = models[arch]
    prompts = _tokens((2, 12), seed=6)
    feats = None
    if pcfg.family == "encdec":
        feats = np.random.default_rng(7).standard_normal((2, 24, pcfg.enc_inputs))
        feats = feats.astype(np.float32)
    ref = r_engine.LMServer(r_registry.get_model(rcfg), rp).generate(
        jnp.asarray(prompts), 6, features=None if feats is None else jnp.asarray(feats))
    before = flash_attention.launches
    out = p_engine.LMServer(p_registry.get_model(pcfg), pp).generate(prompts, 6, features=feats)
    assert flash_attention.launches == before  # the CPU runs the plain version
    assert out.shape == (2, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(ref))


SEQ = 64  # >= 64: one routing group per row, so padded rows leave real rows alone
GRAPH = r_tg.TaskGraph.from_groups([[[0, 1, 2]], [[0, 1], [2]]])


def test_moe_program_serve_batch_matches_reference():
    """A 2-layer qwen2-moe smoke backbone in 2 blocks, 3 tasks, through
    ``MultitaskEngine.serve_batch``: the same groups, counters field for
    field (block costs price a MoE layer as the reference does: a dense MLP
    of ``d_ff``), outputs to 1e-5."""
    rcfg = r_configs.get_smoke_config("qwen2-moe-a2.7b")
    pcfg = p_configs.get_smoke_config("qwen2-moe-a2.7b")
    ref_prog = r_mt.build_transformer_program(jax.random.PRNGKey(0), GRAPH, rcfg, [4, 3, 5], SEQ)
    port_prog = p_mt.transformer_program_from_reference(
        p_tg.TaskGraph(GRAPH.num_tasks, GRAPH.partitions), pcfg,
        _np_tree(ref_prog.node_params), _np_tree(ref_prog.head_params), SEQ, device="cpu",
    )
    assert [dataclasses.asdict(c) for c in port_prog.block_costs] == [
        dataclasses.asdict(c) for c in ref_prog.block_costs]
    ref_engine = r_engine.MultitaskEngine(ref_prog, hw=R_TPU)
    port_engine = p_engine.MultitaskEngine(port_prog, hw=P_TPU)
    subsets = (None, (0, 1), (2,), (1, 2))
    reqs = [(_tokens((1, SEQ), seed=100 + i), subsets[i % 4]) for i in range(7)]
    plan = port_engine.plan_groups([p_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    predicted = port_engine.predicted_group_stats(plan)
    ref_out = ref_engine.serve_batch([r_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    port_out = port_engine.serve_batch([p_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    assert dataclasses.asdict(port_engine.last_batch_stats) == dataclasses.asdict(
        ref_engine.last_batch_stats)
    assert port_engine.last_batch_stats == predicted
    for r, p in zip(ref_out, port_out):
        assert dataclasses.asdict(r.stats) == dataclasses.asdict(p.stats)
        assert set(r.outputs) == set(p.outputs)
        for t in r.outputs:
            _close(p.outputs[t], r.outputs[t], dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("arch,which,ratio", [
    ("qwen2-moe-a2.7b", "get_smoke_config", 3.1425), ("qwen2-moe-a2.7b", "get_config", 22.439),
    ("mixtral-8x22b", "get_config", 6.4194),
])
def test_block_costs_price_moe_layers_as_the_reference_does(arch, which, ratio):
    """The block costs equal the reference's field for field, which prices a
    MoE layer as a dense MLP of ``d_ff``: a layer's parameters outweigh its
    priced weight bytes by ``ratio`` (qwen2-moe-a2.7b: 1.141 GB against
    50.86 MB)."""
    rcfg, pcfg = getattr(r_configs, which)(arch), getattr(p_configs, which)(arch)
    ranges = r_mt._split_layers(rcfg.num_layers, 4)
    ref = r_mt.transformer_block_costs(rcfg, ranges, 128)
    port = p_mt.transformer_block_costs(pcfg, ranges, 128)
    assert [dataclasses.asdict(c) for c in port] == [dataclasses.asdict(c) for c in ref]
    layer = jax.eval_shape(lambda: r_tf._init_layer(jax.random.PRNGKey(0), rcfg))
    nbytes = sum(np.prod(a.shape) * a.dtype.itemsize for a in jax.tree_util.tree_leaves(layer))
    per_layer = port[0].weight_bytes / (ranges[0][1] - ranges[0][0])
    assert nbytes / per_layer == pytest.approx(ratio, rel=1e-4)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-moe-a2.7b"])
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: prints its
    tokens/s line and returns the greedy tokens, those of an LMServer on the
    same seeded weights, prompts and (whisper) features."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = p_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--steps", "4", "--seed", "3"])
    text = buf.getvalue()
    assert "tok/s" in text and "generated 2x4 tokens" in text
    cfg = p_configs.get_smoke_config(arch)
    model = p_registry.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.raw_vocab_size, (2, 8)).astype(np.int32)
    feats = None
    if cfg.family == "encdec":
        feats = rng.normal(size=(2, 8, cfg.enc_inputs)).astype(np.float32)
    np.testing.assert_array_equal(
        out, p_engine.LMServer(model, params).generate(prompts, 4, features=feats))
