"""The port's SSM (Mamba2) and hybrid (Zamba2) families against the JAX
package's.

The same weights (the reference's, carried over as numpy arrays by
``params_from_reference``) and the same token ids go through both packages:
the conv and the Mamba2 block, the models' entry points (``forward``,
``prefill`` with both cache parts, several ``decode_step``s), the cache
shapes and growth, ``LMServer.generate`` and the serve launcher, at the
smoke configs.  On the CPU every full-sequence SSD runs the plain version of
the SSD kernel and the hybrid's shared attention the plain version of the
flash kernel.  Tolerances: fp32 2e-4 (the SSD's chunk sums and exp of
cumulative sums in other orders; the reference sweep's SSD tolerance),
bf16 5e-2 (bf16 roundings at other places).  Greedy tokens are equal exactly
in fp32.
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
from repro.models import hybrid as r_hybrid
from repro.models import registry as r_registry
from repro.models import ssm as r_ssm
from repro.serving import engine as r_engine
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import serve as p_serve
from repro_torch.models import cache as p_cache
from repro_torch.models import hybrid as p_hybrid
from repro_torch.models import multitask as p_mt
from repro_torch.models import registry as p_registry
from repro_torch.models import ssm as p_ssm
from repro_torch.models.transformer import layer_params
from repro_torch.serving import engine as p_engine

P = TP_POLICY
FP32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
ARCHS = ("mamba2-780m", "zamba2-2.7b")
MODULES = {"mamba2-780m": (r_ssm, p_ssm), "zamba2-2.7b": (r_hybrid, p_hybrid)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (dataclasses.replace(r_configs.get_smoke_config(arch), **kw),
            dataclasses.replace(p_configs.get_smoke_config(arch), **kw))


def _model(arch, seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    r_mod, _ = MODULES[arch]
    rp = r_mod.init(jax.random.PRNGKey(seed), rcfg)
    pp = p_mt.params_from_reference(_np_tree(rp), device="cpu")
    return rcfg, pcfg, rp, pp


def _tokens(shape, seed, vocab=1000):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(port, ref, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


def _close_cache(port, ref, tol=FP32):
    if isinstance(port, p_cache.HybridCache):
        _close_cache(port.ssm, ref.ssm, tol)
        _close(port.kv.k, ref.kv.k, tol)
        _close(port.kv.v, ref.kv.v, tol)
        return
    _close(port.conv, ref.conv, tol)
    _close(port.state, ref.state, tol)


# --------------------------------------------------------------------------
# Configs, registry, caches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_builds_the_family(arch):
    cfg = p_configs.get_smoke_config(arch)
    api = p_registry.get_model(cfg)
    assert api.cfg is cfg
    params = api.init(torch.Generator().manual_seed(0), "cpu")
    logits, aux = api.forward(params, _tokens((1, 8), 0))
    assert logits.shape == (1, 8, cfg.vocab_size) and float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_equal_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    ref = r_registry.get_model(rcfg).cache_shape(3, 40)
    port = p_registry.get_model(pcfg).cache_shape(3, 40)
    flat_ref = jax.tree_util.tree_leaves(ref)
    flat_port = [port.conv, port.state] if arch == "mamba2-780m" else [
        port.ssm.conv, port.ssm.state, port.kv.k, port.kv.v]
    assert [tuple(r.shape) for r in flat_ref] == [tuple(t.shape) for t in flat_port]
    assert [str(r.dtype) for r in flat_ref] == [
        str(t.dtype).removeprefix("torch.") for t in flat_port]
    assert all(t.device.type == "meta" for t in flat_port)
    if arch == "mamba2-780m":
        zeros = p_cache.ssm_cache_zeros(pcfg, 3, device="cpu")
        assert zeros.state.shape == flat_port[1].shape and not zeros.state.any()
    else:
        zeros = p_cache.hybrid_cache_zeros(pcfg, 3, 40, device="cpu")
        assert zeros.kv.k.shape == flat_port[2].shape and not zeros.ssm.conv.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_reference_layouts(arch):
    rcfg, pcfg = _cfgs(arch)
    r_mod, p_mod = MODULES[arch]
    ref = _np_tree(r_mod.init(jax.random.PRNGKey(0), rcfg))
    port = p_mod.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    ref_shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref)
    port_shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), port)
    assert port_shapes == ref_shapes
    layers = port["layers"] if arch == "mamba2-780m" else port["mamba"]
    a = -torch.exp(layers["a_log"])
    assert float(a.max()) <= -1.0 + 1e-6 and float(a.min()) >= -16.0 - 1e-4
    dt0 = torch.nn.functional.softplus(layers["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-4) and float(dt0.max()) <= 1e-1 * (1 + 1e-4)
    again = p_mod.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert torch.equal(again["embed"]["unembed"], port["embed"]["unembed"])


def test_params_from_reference_refuses_unported_families():
    """No family is left unported: a MoE tree (router, stacked experts,
    shared experts) and an enc-dec tree (frontend, two stacks) carry over
    leaf for leaf, same shapes, dtypes and values.  The hybrid init still
    refuses configs it cannot build."""
    from repro.models import encdec as r_encdec
    from repro.models import transformer as r_tf

    for arch, r_init in (("qwen2-moe-a2.7b", r_tf.init), ("whisper-medium", r_encdec.init)):
        rcfg, _pcfg = _cfgs(arch)
        ref = _np_tree(r_init(jax.random.PRNGKey(0), rcfg))
        port = p_mt.params_from_reference(ref, device="cpu")
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
        port_leaves, port_def = jax.tree_util.tree_flatten(port)
        assert port_def == ref_def
        for r, t in zip(ref_leaves, port_leaves):
            assert isinstance(t, torch.Tensor) and str(t.dtype).removeprefix("torch.") == str(r.dtype)
            np.testing.assert_array_equal(t.numpy(), r)
    assert port["dec_layers"]["cross_attn"]["w_kv"].shape[:2] == (rcfg.num_layers, rcfg.d_model)
    with pytest.raises(ValueError, match="hybrid"):
        p_hybrid.init(torch.Generator().manual_seed(0),
                      p_configs.get_smoke_config("mamba2-780m"), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        p_hybrid.init(torch.Generator().manual_seed(0), dataclasses.replace(
            p_configs.get_smoke_config("zamba2-2.7b"), num_layers=3), device="cpu")


# --------------------------------------------------------------------------
# Conv and Mamba2 block
# --------------------------------------------------------------------------

def test_causal_conv_and_step_match_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    kernel = rng.standard_normal((4, 12)).astype(np.float32)
    _close(p_ssm.causal_conv(torch.as_tensor(u), torch.as_tensor(kernel)),
           r_ssm.causal_conv(jnp.asarray(u), jnp.asarray(kernel)), dict(rtol=1e-6, atol=1e-6))
    cache = rng.standard_normal((2, 3, 12)).astype(np.float32)
    y, new = p_ssm.causal_conv_step(torch.as_tensor(cache), torch.as_tensor(u[:, 0]),
                                    torch.as_tensor(kernel))
    ry, rnew = r_ssm.causal_conv_step(jnp.asarray(cache), jnp.asarray(u[:, 0]), jnp.asarray(kernel))
    _close(y, ry, dict(rtol=1e-6, atol=1e-6))
    _close(new, rnew, dict(rtol=0, atol=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_is_bit_equal_to_reference(dtype):
    """The conv sums its four taps in fp32 in the reference's order from a
    zero accumulator in the input's own layout: the same bits as the
    reference's eager ``causal_conv``."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((3, 37, 40)).astype(np.float32)
    kernel = rng.standard_normal((4, 40)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = p_ssm.causal_conv(torch.as_tensor(u).to(tdt), torch.as_tensor(kernel).to(tdt))
    ref = r_ssm.causal_conv(jnp.asarray(u).astype(jdt), jnp.asarray(kernel).astype(jdt))
    assert out.dtype == tdt
    assert torch.equal(out, torch.as_tensor(np.asarray(ref.astype(jnp.float32))).to(tdt))


def test_conv_tail_is_a_copy_of_its_rows():
    """``mamba_sequence``'s conv tail owns storage of its own size, so no
    view keeps a layer's whole (B, S, conv_dim) conv input alive."""
    _rcfg, pcfg, _rp, pp = _model("mamba2-780m")
    x = np.random.default_rng(3).standard_normal((2, 40, pcfg.d_model)).astype(np.float32)
    _out, tail, _final = p_ssm.mamba_sequence(layer_params(pp["layers"], 0),
                                              torch.as_tensor(x), pcfg)
    assert tail.shape == (2, pcfg.ssm_conv_width - 1, pcfg.ssm_d_inner + 2 * pcfg.ssm_state)
    assert tail._base is None and tail.is_contiguous()
    assert tail.untyped_storage().nbytes() == tail.numel() * tail.element_size()


@pytest.mark.parametrize("s", [40, 64])
def test_mamba_block_matches_reference(s):
    """The full-sequence block (SSD through ``ops.ssd_scan``), its prefill
    cache derivation, then one decode step from that cache."""
    rcfg, pcfg, rp, pp = _model("mamba2-780m")
    rl = jax.tree_util.tree_map(lambda a: a[1], rp["layers"])
    pl = layer_params(pp["layers"], 1)
    x = np.random.default_rng(1).standard_normal((2, s + 1, rcfg.d_model)).astype(np.float32)
    ref, _ = r_ssm.mamba_block(rl, jnp.asarray(x[:, :s]), rcfg, P)
    before = ssd_scan.launches
    out, cache = p_ssm.mamba_block(pl, torch.as_tensor(x[:, :s]), pcfg)
    assert cache is None and ssd_scan.launches == before
    _close(out, ref)
    out2, tail, final = p_ssm.mamba_sequence(pl, torch.as_tensor(x[:, :s]), pcfg)
    assert torch.equal(out2, out) and tail.shape == (2, 3, pcfg.ssm_d_inner + 32)
    # The last token through the decode path from the prefix's cache.
    ry, (rconv, rstate) = r_ssm.mamba_block(
        rl, jnp.asarray(x[:, s:]), rcfg, P, cache=(jnp.asarray(tail.numpy()),
                                                    jnp.asarray(final.numpy())))
    y, (conv, state) = p_ssm.mamba_block(pl, torch.as_tensor(x[:, s:]), pcfg,
                                         cache=(tail, final))
    _close(y, ry)
    _close(conv, rconv)
    _close(state, rstate)
    full, _ = p_ssm.mamba_block(pl, torch.as_tensor(x), pcfg)
    _close(y, full[:, s:].numpy())


# --------------------------------------------------------------------------
# Model entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    rcfg, pcfg, rp, pp = _model(arch, seed=1)
    r_mod, p_mod = MODULES[arch]
    toks = _tokens((2, 45), seed=1)
    ref_logits, _ = r_mod.forward(rp, jnp.asarray(toks), rcfg, P)
    logits, aux = p_mod.forward(pp, toks, pcfg)
    assert logits.shape == (2, 45, pcfg.vocab_size) and float(aux) == 0.0
    _close(logits, ref_logits)
    ref_last, ref_cache = r_mod.prefill(rp, jnp.asarray(toks), rcfg, P)
    last, cache = p_mod.prefill(pp, toks, pcfg)
    _close(last, ref_last)
    _close(last, logits[:, -1].numpy(), dict(rtol=1e-5, atol=1e-5))
    _close_cache(cache, ref_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    rcfg, pcfg, rp, pp = _model(arch, seed=2)
    r_mod, p_mod = MODULES[arch]
    toks = _tokens((2, 38), seed=2)
    _l, ref_cache = r_mod.prefill(rp, jnp.asarray(toks[:, :33]), rcfg, P)
    _l, cache = p_mod.prefill(pp, toks[:, :33], pcfg)
    ref_cache = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 38, 33)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 38, 33)
    _close_cache(cache, ref_cache)
    full, _ = p_mod.forward(pp, toks, pcfg)
    before = (ssd_scan.launches, flash_attention.launches)
    for t in range(33, 38):
        ref_step, ref_cache = r_mod.decode_step(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, cache = p_mod.decode_step(pp, toks[:, t], cache, t, pcfg)
        _close(step, ref_step)
        _close(step, full[:, t].numpy())
    assert (ssd_scan.launches, flash_attention.launches) == before
    _close_cache(cache, ref_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_updates_the_cache_in_place(arch):
    """decode_step writes the new state into the caller's cache and returns
    that same object (the reference returns an updated copy)."""
    _rcfg, pcfg, _rp, pp = _model(arch, seed=3)
    _r_mod, p_mod = MODULES[arch]
    toks = _tokens((2, 10), seed=3)
    _l, cache = p_mod.prefill(pp, toks[:, :9], pcfg)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 10, 9)
    ssm = cache if arch == "mamba2-780m" else cache.ssm
    state_obj, state_before = ssm.state, ssm.state.clone()
    _s, out = p_mod.decode_step(pp, toks[:, 9], cache, 9, pcfg)
    assert out is cache
    out_ssm = out if arch == "mamba2-780m" else out.ssm
    assert out_ssm.state is state_obj and not torch.equal(state_obj, state_before)
    if arch == "zamba2-2.7b":
        assert cache.kv.k[:, :, 9].abs().sum() > 0 and not cache.kv.k[:, :, 10:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_prefill_match_reference(arch):
    """bf16 activations and weights: logits within 5e-2 x max |logit| of the
    reference's (bf16 rounds at other places in the two packages), and no
    further from an fp32-activation run of the reference, on the same bf16
    weights, than the reference's own bf16 run is (x 1.25)."""
    rcfg, pcfg, rp, pp = _model(arch, dtype="bfloat16", param_dtype="bfloat16")
    r_mod, p_mod = MODULES[arch]
    toks = _tokens((2, 40), seed=4)
    ref_logits, _ = r_mod.forward(rp, jnp.asarray(toks), rcfg, P)
    logits, _ = p_mod.forward(pp, toks, pcfg)
    assert logits.dtype == torch.bfloat16
    ref = np.asarray(ref_logits.astype(jnp.float32))
    port = logits.float().numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(port - ref).max()) <= 5e-2 * scale
    exact, _ = r_mod.forward(rp, jnp.asarray(toks), dataclasses.replace(rcfg, dtype="float32"), P)
    exact = np.asarray(exact)
    assert np.abs(port - exact).max() <= 1.25 * np.abs(ref - exact).max()
    ref_last, ref_cache = r_mod.prefill(rp, jnp.asarray(toks), rcfg, P)
    last, cache = p_mod.prefill(pp, toks, pcfg)
    _close(last, np.asarray(ref_last.astype(jnp.float32)), dict(rtol=0, atol=5e-2 * scale))
    ref_state = ref_cache.state if arch == "mamba2-780m" else ref_cache.ssm.state
    state = cache.state if arch == "mamba2-780m" else cache.ssm.state
    assert state.dtype == torch.float32
    _close(state, ref_state, BF16)


def _with_lora_deltas(rp, seed):
    """The reference tree with nonzero LoRA B matrices (init zeroes them)."""
    rng = np.random.default_rng(seed)
    lora = dict(rp["inv_lora"])
    for name in ("bq", "bkv"):
        lora[name] = jnp.asarray(rng.standard_normal(lora[name].shape).astype(np.float32) * 0.2)
    return {**rp, "inv_lora": lora}


def test_hybrid_lora_deltas_match_reference():
    """Nonzero per-invocation q/kv deltas, set on both sides, through forward,
    prefill and decode (the zero init would leave the delta path untested)."""
    rcfg, pcfg, rp, _pp = _model("zamba2-2.7b", seed=5)
    rp = _with_lora_deltas(rp, seed=5)
    pp = p_mt.params_from_reference(_np_tree(rp), device="cpu")
    assert pp["inv_lora"]["bkv"].abs().sum() > 0
    toks = _tokens((2, 36), seed=5)
    ref_logits, _ = r_hybrid.forward(rp, jnp.asarray(toks), rcfg, P)
    logits, _ = p_hybrid.forward(pp, toks, pcfg)
    _close(logits, ref_logits)
    no_lora = {k: v for k, v in pp.items() if k != "inv_lora"}
    assert not torch.allclose(p_hybrid.forward(no_lora, toks, pcfg)[0], logits, atol=1e-3)
    _l, ref_cache = r_hybrid.prefill(rp, jnp.asarray(toks[:, :34]), rcfg, P)
    _l, cache = p_hybrid.prefill(pp, toks[:, :34], pcfg)
    _close_cache(cache, ref_cache)
    ref_cache = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 36, 34)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 36, 34)
    for t in (34, 35):
        ref_step, ref_cache = r_hybrid.decode_step(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, cache = p_hybrid.decode_step(pp, toks[:, t], cache, t, pcfg)
        _close(step, ref_step)
        _close(step, logits[:, t].numpy())


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_server_greedy_tokens_equal_reference(arch):
    rcfg, pcfg, rp, pp = _model(arch, seed=6)
    prompts = _tokens((2, 20), seed=6)
    ref = r_engine.LMServer(r_registry.get_model(rcfg), rp).generate(jnp.asarray(prompts), 8)
    before = (ssd_scan.launches, flash_attention.launches)
    out = p_engine.LMServer(p_registry.get_model(pcfg), pp).generate(prompts, 8)
    assert (ssd_scan.launches, flash_attention.launches) == before  # plain versions on the CPU
    assert out.shape == (2, 8) and out.dtype == np.int32
    np.testing.assert_array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_grow_cache_matches_reference(arch):
    """An SSM cache stays as it is; a hybrid cache's KV part gains zero
    slots up to the total, its SSM part unchanged."""
    rcfg, pcfg, rp, pp = _model(arch, seed=7)
    r_mod, p_mod = MODULES[arch]
    toks = _tokens((2, 12), seed=7)
    _l, ref_cache = r_mod.prefill(rp, jnp.asarray(toks), rcfg, P)
    _l, cache = p_mod.prefill(pp, toks, pcfg)
    grown = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 20, 12)
    ref_grown = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 20, 12)
    if arch == "mamba2-780m":
        assert grown is cache
    else:
        assert grown.ssm is cache.ssm and grown.kv.capacity == 20 == ref_grown.kv.k.shape[2]
        assert not grown.kv.v[:, :, 12:].any()
    _close_cache(grown, ref_grown)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: prints its
    tokens/s line and returns the greedy tokens, those of an LMServer on the
    same seeded weights and prompts."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = p_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--steps", "4", "--seed", "3"])
    text = buf.getvalue()
    assert "tok/s" in text and "device=cpu" in text and "generated 2x4 tokens" in text
    cfg = p_configs.get_smoke_config(arch)
    model = p_registry.get_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.raw_vocab_size, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(out, p_engine.LMServer(model, params).generate(prompts, 4))
