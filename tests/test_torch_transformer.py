"""The port's dense transformer family against the JAX package's.

The same weights (the reference's, carried over as numpy arrays) and the
same token ids go through both packages: the layers, the model's entry
points, the multitask transformer program under both executors, the serving
engine and the LM server.  Tolerances: fp32 2e-5 (products and softmax
summed in other orders; the port's attention is the dense plain version of
the flash kernel, the reference's its chunked jnp oracle), bf16 5e-2 (bf16
roundings at other places).  Counters, traces, dispatch modes, block costs
and greedy tokens are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.core import executor as r_ex
from repro.core import task_graph as r_tg
from repro.core.types import TPU_V5E as R_TPU
from repro.models import layers as r_layers
from repro.models import multitask as r_mt
from repro.models import registry as r_registry
from repro.models import transformer as r_tf
from repro.models.cache import kv_cache_shape as r_kv_cache_shape
from repro.serving import engine as r_engine
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.core import executor as p_ex
from repro_torch.core import task_graph as p_tg
from repro_torch.core.types import TPU_V5E as P_TPU
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import cache as p_cache
from repro_torch.models import layers as p_layers
from repro_torch.models import multitask as p_mt
from repro_torch.models import registry as p_registry
from repro_torch.models import transformer as p_tf
from repro_torch.serving import engine as p_engine

P = TP_POLICY
FP32 = dict(rtol=2e-5, atol=2e-5)
DENSE = ("mistral-nemo-12b", "granite-34b", "granite-20b", "nemotron-4-340b")
SSM_FAMILIES = ("mamba2-780m", "zamba2-2.7b")  # tested in tests/test_torch_ssm.py
# tested in tests/test_torch_moe.py, test_torch_families.py and test_torch_encdec.py
MOE_VLM_ENCDEC = ("qwen2-moe-a2.7b", "mixtral-8x22b", "chameleon-34b", "whisper-medium")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch="mistral-nemo-12b", **kw):
    """The smoke config of ``arch`` in both packages, with ``kw`` replaced."""
    return (dataclasses.replace(r_configs.get_smoke_config(arch), **kw),
            dataclasses.replace(p_configs.get_smoke_config(arch), **kw))


def _model(arch="mistral-nemo-12b", seed=0, **kw):
    rcfg, pcfg = _cfgs(arch, **kw)
    rp = r_tf.init(jax.random.PRNGKey(seed), rcfg)
    pp = p_mt.params_from_reference(_np_tree(rp), device="cpu")
    return rcfg, pcfg, rp, pp


def _tokens(shape, seed, vocab=1000):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(port, ref, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


# --------------------------------------------------------------------------
# Configs, registry, cache shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + SSM_FAMILIES + MOE_VLM_ENCDEC)
def test_configs_equal_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ref = dataclasses.asdict(getattr(r_configs, get)(arch))
        port = dataclasses.asdict(getattr(p_configs, get)(arch))
        assert port == ref
    cfg = p_configs.get_config(arch)
    assert cfg.params_dtype() == torch.bfloat16
    assert p_configs.get_smoke_config(arch).activation_dtype() == torch.float32


def test_registry_lists_ported_archs_and_refuses_others():
    """Every arch of the reference's zoo is ported and listed in its order;
    ``get_model`` serves all six families; an unknown arch raises."""
    assert p_configs.list_archs() == r_configs.list_archs()
    assert set(p_configs.list_archs()) == set(DENSE + SSM_FAMILIES + MOE_VLM_ENCDEC)
    families = set()
    for arch in p_configs.list_archs():
        cfg = p_configs.get_smoke_config(arch)
        assert p_registry.get_model(cfg).cfg is cfg
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
    with pytest.raises(KeyError, match="unknown"):
        p_configs.get_config("gpt-5")
    with pytest.raises(ValueError, match="decoder runs"):
        p_tf.init(torch.Generator().manual_seed(0), p_configs.get_smoke_config("mamba2-780m"),
                  device="cpu")


@pytest.mark.parametrize("window", [None, 16])
def test_cache_shapes_equal_reference(window):
    rcfg, pcfg = _cfgs(sliding_window=window)
    ref = r_kv_cache_shape(rcfg, 3, 40)
    port = p_cache.kv_cache_shape(pcfg, 3, 40)
    assert port.k.shape == ref.k.shape and port.k.device.type == "meta"
    assert port.capacity == ref.capacity
    zeros = p_cache.kv_cache_zeros(pcfg, 3, 40, device="cpu")
    assert zeros.v.shape == ref.v.shape and not zeros.v.any()
    api = p_registry.get_model(pcfg)
    assert api.cache_shape(3, 40).k.shape == ref.k.shape


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def test_rmsnorm_matches_reference_fp32_inside():
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(np.float32) * 30
    scale = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    ref = r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    _close(p_layers.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x), 1e-5), ref)
    xb = torch.as_tensor(x).bfloat16()
    ref_b = r_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jnp.bfloat16), 1e-5)
    out_b = p_layers.rmsnorm({"scale": torch.as_tensor(scale)}, xb, 1e-5)
    assert out_b.dtype == torch.bfloat16
    _close(out_b, np.asarray(ref_b.astype(jnp.float32)), dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("head_dim,theta", [(32, 1e6), (160, 1e6), (48, 1e4)])
def test_rope_rotates_halves_like_reference(head_dim, theta):
    x = np.random.default_rng(head_dim).standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) * 37
    ref = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = p_layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(out, ref, dict(rtol=2e-5, atol=2e-5))
    # Rotate-half, not interleaved pairs: dims 0 and half pair up.
    x1 = torch.zeros(1, 1, 1, head_dim)
    x1[..., 0] = 1.0
    rot = p_layers.apply_rope(x1, torch.tensor([1]), theta)
    assert rot[..., head_dim // 2].abs() > 0.5 and rot[..., 1] == 0


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(activation):
    arch = "nemotron-4-340b" if activation == "squared_relu" else "mistral-nemo-12b"
    rcfg, pcfg = _cfgs(arch, activation=activation)
    rp = r_layers.init_mlp(jax.random.PRNGKey(3), rcfg)
    pp = p_mt.params_from_reference(_np_tree(rp), device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 6, rcfg.d_model)).astype(np.float32)
    ref = r_layers.mlp_block(rp, jnp.asarray(x), rcfg, P)
    _close(p_layers.mlp_block(pp, torch.as_tensor(x), pcfg), ref)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_block_and_layer_match_reference(window):
    rcfg, pcfg, rp, pp = _model(sliding_window=window)
    rl = jax.tree_util.tree_map(lambda a: a[1], rp["layers"])
    pl = p_tf.layer_params(pp["layers"], 1)
    x = np.random.default_rng(4).standard_normal((2, 19, rcfg.d_model)).astype(np.float32)
    pos = np.arange(19, dtype=np.int32)
    ref, _ = r_layers.attention_block(rl["attn"], jnp.asarray(x), rcfg, P, jnp.asarray(pos))
    out, cache = p_layers.attention_block(pl["attn"], torch.as_tensor(x), pcfg,
                                          torch.as_tensor(pos))
    assert cache is None
    _close(out, ref)
    ref_x, _, _ = r_tf._layer_apply(rl, jnp.asarray(x), rcfg, P, jnp.asarray(pos))
    out_x, _, _ = p_tf._layer_apply(pl, torch.as_tensor(x), pcfg, torch.as_tensor(pos))
    _close(out_x, ref_x)
    ref_kv = r_tf._layer_apply(rl, jnp.asarray(x), rcfg, P, jnp.asarray(pos), return_kv=True)
    out_kv = p_tf._layer_apply(pl, torch.as_tensor(x), pcfg, torch.as_tensor(pos),
                               return_kv=True)
    _close(out_kv[0], ref_kv[0])
    for a, b in zip(out_kv[1], ref_kv[1]):
        _close(a, b)


def test_dense_attention_and_multi_token_cache():
    rcfg, pcfg, rp, pp = _model()
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    pos = np.arange(9)
    ref = r_layers.attention_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                   jnp.asarray(pos), jnp.asarray(pos), window=4)
    out = p_layers.attention_dense(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(k),
                                   torch.as_tensor(pos), torch.as_tensor(pos), window=4)
    _close(out, ref)
    # Three new tokens over a 16-slot cache holding 4: the reference's
    # chunked branch with ``kv_valid`` (tests/test_torch_lm_batching.py
    # holds the ring and the chunk padding too).
    ck = rng.standard_normal((2, 16, pcfg.n_kv_heads, pcfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal((2, 16, pcfg.n_kv_heads, pcfg.head_dim)).astype(np.float32)
    x = rng.standard_normal((2, 3, pcfg.d_model)).astype(np.float32)
    pos = np.arange(4, 7, dtype=np.int32)
    r_out, (r_ck, r_cv) = r_layers.attention_block(
        jax.tree_util.tree_map(lambda a: a[0], rp["layers"])["attn"], jnp.asarray(x), rcfg,
        P, jnp.asarray(pos), kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(4, jnp.int32))
    p_out, (p_ck, p_cv) = p_layers.attention_block(
        p_tf.layer_params(pp["layers"], 0)["attn"], torch.as_tensor(x), pcfg,
        torch.as_tensor(pos), kv_cache=(torch.as_tensor(ck), torch.as_tensor(cv)), cache_len=4)
    _close(p_out, r_out)
    _close(p_ck, r_ck)
    _close(p_cv, r_cv)


# --------------------------------------------------------------------------
# Model entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-20b", "nemotron-4-340b"])
def test_forward_hidden_prefill_match_reference(arch):
    rcfg, pcfg, rp, pp = _model(arch, num_layers=4)
    toks = _tokens((2, 40), seed=1)
    ref_logits, _ = r_tf.forward(rp, jnp.asarray(toks), rcfg, P)
    logits, aux = p_tf.forward(pp, toks, pcfg)
    assert logits.shape == (2, 40, pcfg.vocab_size) and float(aux) == 0.0
    _close(logits, ref_logits)
    _close(p_tf.hidden_states(pp, toks, pcfg, upto_layer=2),
           r_tf.hidden_states(rp, jnp.asarray(toks), rcfg, P, upto_layer=2))
    ref_last, ref_cache = r_tf.prefill(rp, jnp.asarray(toks), rcfg, P)
    last, cache = p_tf.prefill(pp, toks, pcfg)
    _close(last, ref_last)
    _close(cache.k, ref_cache.k)
    _close(cache.v, ref_cache.v)


def test_decode_steps_match_reference():
    rcfg, pcfg, rp, pp = _model(num_layers=4, seed=1)
    toks = _tokens((2, 36), seed=2)
    _l, ref_cache = r_tf.prefill(rp, jnp.asarray(toks[:, :32]), rcfg, P)
    _l, cache = p_tf.prefill(pp, toks[:, :32], pcfg)
    ref_model = r_registry.get_model(rcfg)
    port_model = p_registry.get_model(pcfg)
    ref_cache = r_engine._grow_cache(ref_model, ref_cache, 36, 32)
    cache = p_engine._grow_cache(port_model, cache, 36, 32)
    assert cache.capacity == ref_cache.capacity == 36
    full, _ = p_tf.forward(pp, toks, pcfg)
    for t in range(32, 36):
        ref_step, ref_cache = r_tf.decode_step(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, cache = p_tf.decode_step(pp, toks[:, t], cache, t, pcfg)
        _close(step, ref_step)
        _close(step, full[:, t].numpy(), dict(rtol=1e-4, atol=1e-4))
    _close(cache.k, ref_cache.k)


def test_decode_step_writes_the_cache_in_place():
    """decode_step writes slot ``cache_len % capacity`` of the caller's cache
    and returns that same object; every other slot stays as it was.  The
    values written are the reference's, whose cache is an updated copy."""
    rcfg, pcfg, rp, pp = _model(num_layers=2, seed=4)
    toks = _tokens((2, 11), seed=6)
    _l, ref_cache = r_tf.prefill(rp, jnp.asarray(toks[:, :10]), rcfg, P)
    _l, cache = p_tf.prefill(pp, toks[:, :10], pcfg)
    ref_cache = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 12, 10)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 12, 10)
    k_obj, v_obj = cache.k, cache.v
    k_before, v_before = cache.k.clone(), cache.v.clone()
    _s, ref_new = r_tf.decode_step(rp, jnp.asarray(toks[:, 10]), ref_cache, jnp.asarray(10), rcfg, P)
    _s, out = p_tf.decode_step(pp, toks[:, 10], cache, 10, pcfg)
    assert out is cache and out.k is k_obj and out.v is v_obj
    other = [i for i in range(cache.capacity) if i != 10]
    assert torch.equal(cache.k[:, :, other], k_before[:, :, other])
    assert torch.equal(cache.v[:, :, other], v_before[:, :, other])
    assert not torch.equal(cache.k[:, :, 10], k_before[:, :, 10])
    _close(cache.k[:, :, 10], np.asarray(ref_new.k)[:, :, 10])
    _close(cache.v[:, :, 10], np.asarray(ref_new.v)[:, :, 10])
    np.testing.assert_array_equal(np.asarray(ref_cache.k)[:, :, 10], 0)  # the copy's source


def test_bf16_forward_and_prefill_match_reference():
    rcfg, pcfg, rp, pp = _model(num_layers=4, dtype="bfloat16", param_dtype="bfloat16")
    assert pp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    toks = _tokens((2, 24), seed=3)
    ref_logits, _ = r_tf.forward(rp, jnp.asarray(toks), rcfg, P)
    logits, _ = p_tf.forward(pp, toks, pcfg)
    assert logits.dtype == torch.bfloat16
    tol = dict(rtol=5e-2, atol=5e-2)
    _close(logits, np.asarray(ref_logits.astype(jnp.float32)), tol)
    ref_last, _ = r_tf.prefill(rp, jnp.asarray(toks), rcfg, P)
    last, _ = p_tf.prefill(pp, toks, pcfg)
    _close(last, np.asarray(ref_last.astype(jnp.float32)), tol)


def test_sliding_window_ring_matches_reference():
    """Prefill past the window rolls the trailing window into a ring
    (slot = position % window); decode then writes and reads the ring."""
    rcfg, pcfg, rp, pp = _model(num_layers=2, sliding_window=16, seed=2)
    toks = _tokens((2, 45), seed=4)
    ref_last, ref_cache = r_tf.prefill(rp, jnp.asarray(toks[:, :41]), rcfg, P)
    last, cache = p_tf.prefill(pp, toks[:, :41], pcfg)
    assert cache.capacity == 16
    _close(last, ref_last)
    _close(cache.k, ref_cache.k)
    full, _ = p_tf.forward(pp, toks, pcfg)
    for t in range(41, 45):
        ref_step, ref_cache = r_tf.decode_step(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, cache = p_tf.decode_step(pp, toks[:, t], cache, t, pcfg)
        _close(step, ref_step)
        _close(step, full[:, t].numpy(), dict(rtol=1e-4, atol=1e-4))
    _close(cache.v, ref_cache.v)


@pytest.mark.parametrize("window", [None, 8])
def test_lm_server_greedy_tokens_equal_reference(window):
    rcfg, pcfg, rp, pp = _model(num_layers=2, seed=3, sliding_window=window)
    prompts = _tokens((2, 12), seed=5)
    ref = r_engine.LMServer(r_registry.get_model(rcfg), rp).generate(jnp.asarray(prompts), 6)
    before = flash_attention.launches
    out = p_engine.LMServer(p_registry.get_model(pcfg), pp).generate(prompts, 6)
    assert flash_attention.launches == before  # the CPU runs the plain version
    assert out.shape == (2, 6)
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_init_layers_draws_in_place_what_stacking_drew():
    """``init_layers`` writes each layer's draws into a preallocated stack;
    the result is bit-equal to drawing every layer first and stacking them
    (the earlier way, which held two copies of the weights at its peak)."""
    _rcfg, pcfg = _cfgs(num_layers=3)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    gen = torch.Generator().manual_seed(7)
    stacked = stack([p_tf._init_layer(gen, pcfg, torch.device("cpu")) for _ in range(3)])
    after = torch.rand(4, generator=gen)
    gen = torch.Generator().manual_seed(7)
    in_place = p_tf.init_layers(gen, pcfg, 3, torch.device("cpu"))
    assert torch.equal(torch.rand(4, generator=gen), after)  # the same number of draws
    flat = lambda tree: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, in_place)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, stacked))
    for a, b in zip(flat(in_place), flat(stacked)):
        np.testing.assert_array_equal(a, b)


def test_init_draws_reference_layouts():
    rcfg, pcfg = _cfgs(num_layers=3)
    ref = _np_tree(r_tf.init(jax.random.PRNGKey(0), rcfg))
    port = p_tf.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    ref_shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref)
    port_shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), port)
    assert port_shapes == ref_shapes
    w = port["layers"]["attn"]["wq"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(pcfg.d_model) + 1e-6  # truncated at 2 std
    again = p_tf.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert torch.equal(again["embed"]["unembed"], port["embed"]["unembed"])


# --------------------------------------------------------------------------
# The multitask transformer program
# --------------------------------------------------------------------------

GRAPH = r_tg.TaskGraph.from_groups([
    [[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]],
])
SEQ = 12


def _programs(arch="mistral-nemo-12b", **kw):
    rcfg, pcfg = _cfgs(arch, num_layers=3, **kw)
    ref = r_mt.build_transformer_program(jax.random.PRNGKey(0), GRAPH, rcfg, [4, 3, 5], SEQ)
    port = p_mt.transformer_program_from_reference(
        p_tg.TaskGraph(GRAPH.num_tasks, GRAPH.partitions), pcfg,
        _np_tree(ref.node_params), _np_tree(ref.head_params), SEQ, device="cpu",
    )
    return ref, port


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("which", ["smoke", "full"])
def test_block_costs_equal_reference(arch, which):
    get = "get_config" if which == "full" else "get_smoke_config"
    rcfg, pcfg = getattr(r_configs, get)(arch), getattr(p_configs, get)(arch)
    for layers, blocks, seq in ((rcfg.num_layers, 4, 128), (8, 4, 128), (7, 3, 100)):
        ranges = r_mt._split_layers(layers, blocks)
        assert p_mt._split_layers(layers, blocks) == ranges
        ref = r_mt.transformer_block_costs(rcfg, ranges, seq)
        port = p_mt.transformer_block_costs(pcfg, ranges, seq)
        assert [dataclasses.asdict(c) for c in port] == [dataclasses.asdict(c) for c in ref]


def _assert_same(ref_result, port_result, ref_ex, port_ex):
    (r_out, r_stats), (p_out, p_stats) = ref_result, port_result
    assert dataclasses.asdict(r_stats) == dataclasses.asdict(p_stats)
    assert set(r_out) == set(p_out)
    for t in r_out:
        _close(p_out[t], r_out[t])
    assert ref_ex.dispatch_count == port_ex.dispatch_count
    assert ref_ex.residency_state() == port_ex.residency_state()
    assert [dataclasses.asdict(r) for r in ref_ex.last_trace] == [
        dataclasses.asdict(r) for r in port_ex.last_trace]
    ref_modes = {k[:4]: m for k, (_f, m) in ref_ex._compiled_fused.items()}
    port_modes = {k[:4]: m for k, (_f, m) in port_ex._compiled_fused.items()}
    assert port_modes == ref_modes


@pytest.mark.parametrize("fused", [True, False])
def test_program_executors_match_reference(fused):
    ref_prog, port_prog = _programs()
    ref_ex = r_ex.TaskGraphExecutor(ref_prog, fused=fused)
    port_ex = p_ex.TaskGraphExecutor(port_prog, fused=fused)
    xs = _tokens((4, 1, SEQ), seed=6)
    _assert_same(ref_ex.run_batch(jnp.asarray(xs), [2, 0, 1], valid=3),
                 port_ex.run_batch(torch.as_tensor(xs), [2, 0, 1], valid=3), ref_ex, port_ex)
    x = _tokens((2, SEQ), seed=7)
    _assert_same(ref_ex.run(jnp.asarray(x), [0, 1, 2]),
                 port_ex.run(torch.as_tensor(x), [0, 1, 2]), ref_ex, port_ex)
    if fused:
        # One closure per depth: never the homogeneous "scan" mode.
        assert set(m for _f, m in port_ex._compiled_fused.values()) == {"unrolled"}
    _o, r_van = r_ex.VanillaExecutor(ref_prog).run(jnp.asarray(x), [1, 2, 0])
    _o, p_van = p_ex.VanillaExecutor(port_prog).run(torch.as_tensor(x), [1, 2, 0])
    assert dataclasses.asdict(r_van) == dataclasses.asdict(p_van)


def test_built_program_shapes_and_head_standardisation():
    """A program built by the port draws the reference's tree layout, and
    its head standardises with the population std (``jnp.std``, ddof 0)."""
    ref_prog, port_prog = _programs()
    built = p_mt.build_transformer_program(
        port_prog.graph, _cfgs(num_layers=3)[1], [4, 3, 5], SEQ,
        generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), tree)
    for node in GRAPH.nodes():
        assert shapes(built.node_params[node]) == shapes(_np_tree(ref_prog.node_params[node]))
    assert [dataclasses.asdict(c) for c in built.block_costs] == [
        dataclasses.asdict(c) for c in ref_prog.block_costs]
    # Rows where ddof matters: a short hidden size, spread values.
    x = np.random.default_rng(8).standard_normal((3, 5, 6)).astype(np.float32) * 4
    head = {"w": np.eye(6, 4, dtype=np.float32), "b": np.arange(4, dtype=np.float32)}
    ref = ref_prog.head_fns[0]({k: jnp.asarray(v) for k, v in head.items()}, jnp.asarray(x))
    out = port_prog.head_fns[0]({k: torch.as_tensor(v) for k, v in head.items()},
                                torch.as_tensor(x))
    _close(out, ref)
    sample = torch.as_tensor(x)[:, -1]
    ddof1 = (sample - sample.mean(-1, keepdim=True)) / (sample.std(-1, keepdim=True) + 1e-6)
    assert not torch.allclose(out, ddof1[:, :4] + torch.arange(4.0), atol=1e-3)


def test_engine_serve_batch_counters_equal_reference():
    ref_prog, port_prog = _programs()
    ref_engine = r_engine.MultitaskEngine(ref_prog, hw=R_TPU)
    port_engine = p_engine.MultitaskEngine(port_prog, hw=P_TPU)
    assert ref_engine.order == port_engine.order
    subsets = (None, (0, 1), (2,), (1, 2))
    rng = np.random.default_rng(9)
    reqs = [(_tokens((1, SEQ), seed=100 + i), subsets[int(rng.integers(4))]) for i in range(9)]
    plan = port_engine.plan_groups([p_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    predicted = port_engine.predicted_group_stats(plan)
    ref_out = ref_engine.serve_batch([r_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    port_out = port_engine.serve_batch([p_engine.MultitaskRequest(x=x, tasks=t) for x, t in reqs])
    assert dataclasses.asdict(port_engine.last_batch_stats) == dataclasses.asdict(
        ref_engine.last_batch_stats)
    assert port_engine.last_batch_stats == predicted
    for r, p in zip(ref_out, port_out):
        assert dataclasses.asdict(r.stats) == dataclasses.asdict(p.stats)
        assert (r.effective_order, r.group_size) == (p.effective_order, p.group_size)
        assert set(r.outputs) == set(p.outputs)
        for t in r.outputs:
            _close(p.outputs[t], r.outputs[t])
