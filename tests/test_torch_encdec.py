"""The port's Whisper-style encoder-decoder against the JAX package's.

The same weights (the reference's, carried over by ``params_from_reference``),
frontend features and token ids go through both packages at the smoke
config (chunk 64): ``sinusoids``, ``encode``, ``forward``, ``prefill`` and
``decode_step``, at a T_enc of 24 (not a multiple of the chunk, so the
reference's chunked attention lets 40 zero keys into the softmax of every
encoder and cross-attention of ``encode`` and ``forward``), of 100 (past
the chunk and ragged: ``prefill`` and ``decode_step`` dilute too) and of
128 (a multiple: no dilution).  Tolerances: fp32 2e-5; decode against
forward 3e-3 (``tests/test_models_equiv.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import encdec as r_encdec
from repro.models import layers as r_layers
from repro.models import make_config as r_make_config
from repro.models import registry as r_registry
from repro.models.cache import encdec_cache_shape as r_encdec_cache_shape
from repro.serving import engine as r_engine
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import cache as p_cache
from repro_torch.models import encdec as p_encdec
from repro_torch.models import layers as p_layers
from repro_torch.models import multitask as p_mt
from repro_torch.models import registry as p_registry
from repro_torch.models.config import make_config as p_make_config
from repro_torch.serving import engine as p_engine

P = TP_POLICY
FP32 = dict(rtol=2e-5, atol=2e-5)
DECODE = dict(rtol=3e-3, atol=3e-3)
ARCH = "whisper-medium"
# The reference's entry points, each compiled once per input shape.
R_ENCODE = jax.jit(r_encdec.encode, static_argnums=(2, 3))
R_FORWARD = jax.jit(r_encdec.forward, static_argnums=(3, 4))
R_PREFILL = jax.jit(r_encdec.prefill, static_argnums=(3, 4))
R_DECODE = jax.jit(r_encdec.decode_step, static_argnums=(4, 5))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, tol=FP32):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **tol)


def _feats(b, t, seed, width=80):
    return np.random.default_rng(seed).standard_normal((b, t, width)).astype(np.float32)


def _tokens(shape, seed, vocab=1000):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = r_configs.get_smoke_config(ARCH), p_configs.get_smoke_config(ARCH)
    rp = r_encdec.init(jax.random.PRNGKey(0), rcfg)
    return rcfg, pcfg, rp, p_mt.params_from_reference(_np_tree(rp), device="cpu")


def test_sinusoids_match_reference():
    """Row p to 2e-6 + p * 2^-23: XLA's and PyTorch's fp32 ``exp`` may
    differ by one ulp in an inverse timescale, which the position multiplies
    (up to 1.2e-4 at Whisper's 1500 frames)."""
    for length, channels in ((24, 128), (1500, 1024), (7, 10)):
        gap = np.abs(p_encdec.sinusoids(length, channels).numpy()
                     - np.asarray(r_encdec.sinusoids(length, channels)))
        assert (gap <= 2e-6 + np.arange(length)[:, None] * 2.0 ** -23).all(), gap.max()
    rows = p_encdec._sinusoid_rows(torch.tensor([5, 0, 1499]), 1024)
    assert torch.equal(rows, p_encdec.sinusoids(1500, 1024)[[5, 0, 1499]])


def test_cache_shapes_and_registry_equal_reference():
    rcfg, pcfg = r_configs.get_smoke_config(ARCH), p_configs.get_smoke_config(ARCH)
    ref = r_encdec_cache_shape(rcfg, 3, 40, 24)
    port = p_cache.encdec_cache_shape(pcfg, 3, 40, 24)
    assert port.self_kv.k.shape == ref.self_kv.k.shape and port.cross_v.shape == ref.cross_v.shape
    assert port.cross_k.device.type == "meta"
    zeros = p_cache.encdec_cache_zeros(pcfg, 3, 40, 24, device="cpu")
    assert zeros.cross_k.shape == ref.cross_k.shape and not zeros.self_kv.v.any()
    ref_api = r_registry.get_model(rcfg).cache_shape(2, 16)
    port_api = p_registry.get_model(pcfg).cache_shape(2, 16)
    assert port_api.cross_k.shape == ref_api.cross_k.shape  # WHISPER_ENC_LEN frames
    assert p_registry.WHISPER_ENC_LEN == r_registry.WHISPER_ENC_LEN == 1500


@pytest.mark.parametrize("t,chunk", [(24, 64), (24, 8), (128, 64)])
def test_reference_keys_dilute_like_the_reference(t, chunk):
    """The reference's chunked non-causal attention at a T that is not a
    multiple of the chunk differs from its dense attention by the zero keys
    it lets in (B 2, S 5, T 24, 4 heads, d 8, ``default_rng(0)`` normals:
    0.5423 at chunk 64, ~4e-7 at chunk 8); the port's padded keys through
    the flash kernel's plain version equal the reference's chunked result
    and differ from the port's dense attention by the same amount."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, t, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, t, 4, 8)).astype(np.float32)
    qp, kp = np.arange(5), np.arange(t)
    ref_chunked = r_layers.attention_chunked(*map(jnp.asarray, (q, k, v, qp, kp)), causal=False,
                                             chunk=chunk)
    ref_dense = r_layers.attention_dense(*map(jnp.asarray, (q, k, v, qp, kp)), causal=False)
    kk, vv = p_encdec.reference_keys(torch.as_tensor(k), torch.as_tensor(v), chunk,
                                     chunked=True, causal=False)
    assert kk.shape[1] == chunk * -(-t // chunk) and not kk[:, t:].any()
    port = ops.flash_attention_bhsd(torch.as_tensor(q), kk, vv, causal=False)
    port_dense = p_layers.attention_dense(*map(torch.as_tensor, (q, k, v, qp, kp)), causal=False)
    _close(port, ref_chunked)
    ref_gap = np.abs(np.asarray(ref_chunked) - np.asarray(ref_dense)).max()
    gap = float((port - port_dense).abs().max())
    assert abs(gap - ref_gap) <= 1e-5
    if t % chunk:
        assert ref_gap == pytest.approx(0.5423, abs=1e-4)
    else:
        assert ref_gap < 1e-5
    for chunked, causal in ((False, False), (True, True)):
        same = p_encdec.reference_keys(torch.as_tensor(k), torch.as_tensor(v), chunk, chunked,
                                       causal)
        assert same[0].shape[1] == t


@pytest.mark.parametrize("t_enc", [24, 100])
def test_decode_matches_forward_only_past_the_chunk(model, t_enc):
    """Within the reference, where T_enc is at most the chunk and not a
    multiple of it, ``forward`` pads the cross-attention's keys and
    ``prefill``/``decode_step`` do not: decode differs from forward (by
    1.34 on logits of max 2.99 at T_enc 24), in the port by the same gap.
    Past the chunk (T_enc 100) both pad, and decode matches forward."""
    rcfg, pcfg, rp, pp = model
    feats, toks = _feats(2, t_enc, seed=1), _tokens((2, 20), seed=2)
    gaps = []
    full, _ = R_FORWARD(rp, jnp.asarray(feats), jnp.asarray(toks), rcfg, P)
    _l, cache = R_PREFILL(rp, jnp.asarray(feats), jnp.asarray(toks[:, :19]), rcfg, P)
    cache = r_engine._grow_cache(r_registry.get_model(rcfg), cache, 20, 19)
    step, _ = R_DECODE(rp, jnp.asarray(toks[:, 19]), cache, jnp.asarray(19), rcfg, P)
    gaps.append(float(jnp.abs(step - full[:, 19]).max()))
    full, _ = p_encdec.forward(pp, feats, toks, pcfg)
    _l, cache = p_encdec.prefill(pp, feats, toks[:, :19], pcfg)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 20, 19)
    step, _ = p_encdec.decode_step(pp, toks[:, 19], cache, 19, pcfg)
    gaps.append(float((step - full[:, 19]).abs().max()))
    assert gaps[1] == pytest.approx(gaps[0], abs=1e-4)
    if t_enc < pcfg.attn_chunk:
        assert gaps[0] == pytest.approx(1.342, abs=1e-3)
    else:
        assert gaps[0] < 3e-3


@pytest.mark.parametrize("t_enc", [24, 100, 128])
def test_encode_forward_prefill_match_reference(model, t_enc):
    rcfg, pcfg, rp, pp = model
    feats, toks = _feats(2, t_enc, seed=1), _tokens((2, 20), seed=2)
    _close(p_encdec.encode(pp, feats, pcfg), R_ENCODE(rp, jnp.asarray(feats), rcfg, P))
    ref_logits, _ = R_FORWARD(rp, jnp.asarray(feats), jnp.asarray(toks), rcfg, P)
    logits, aux = p_encdec.forward(pp, feats, toks, pcfg)
    assert logits.shape == (2, 20, pcfg.vocab_size) and float(aux) == 0.0
    _close(logits, ref_logits)
    ref_last, ref_cache = R_PREFILL(rp, jnp.asarray(feats), jnp.asarray(toks), rcfg, P)
    last, cache = p_encdec.prefill(pp, feats, toks, pcfg)
    _close(last, ref_last)
    for port, ref in ((cache.self_kv.k, ref_cache.self_kv.k),
                      (cache.self_kv.v, ref_cache.self_kv.v),
                      (cache.cross_k, ref_cache.cross_k), (cache.cross_v, ref_cache.cross_v)):
        assert tuple(port.shape) == ref.shape
        _close(port, ref)


@pytest.mark.parametrize("t_enc", [24, 100, 128])
def test_decode_steps_match_reference(model, t_enc):
    """The self K/V written in place at ``cache_len``; cross K/V untouched."""
    rcfg, pcfg, rp, pp = model
    feats, toks = _feats(2, t_enc, seed=3), _tokens((2, 24), seed=4)
    _l, ref_cache = R_PREFILL(rp, jnp.asarray(feats), jnp.asarray(toks[:, :20]), rcfg, P)
    _l, cache = p_encdec.prefill(pp, feats, toks[:, :20], pcfg)
    ref_cache = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 24, 20)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 24, 20)
    assert cache.self_kv.capacity == 24 and not cache.self_kv.k[:, :, 20:].any()
    cross = cache.cross_k.clone()
    for t in range(20, 24):
        ref_step, ref_cache = R_DECODE(
            rp, jnp.asarray(toks[:, t]), ref_cache, jnp.asarray(t), rcfg, P)
        step, out = p_encdec.decode_step(pp, toks[:, t], cache, t, pcfg)
        assert out is cache
        _close(step, ref_step)
    _close(cache.self_kv.k, ref_cache.self_kv.k)
    _close(cache.self_kv.v, ref_cache.self_kv.v)
    assert torch.equal(cache.cross_k, cross)


def test_encdec_decode_matches_forward():
    """``tests/test_models_equiv.py::test_encdec_decode_matches_forward`` on
    the port: 24 frames at chunk 8 (a multiple), a 19-token prefill, one
    decode step against ``forward``'s 20th position to 3e-3."""
    kw = dict(
        name="e", family="encdec", num_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=300, enc_layers=2, enc_inputs=16,
        activation="gelu", dtype="float32", param_dtype="float32",
        remat=False, attn_chunk=8,
    )
    rcfg, pcfg = r_make_config(**kw), p_make_config(**kw)
    pp = p_mt.params_from_reference(_np_tree(r_encdec.init(jax.random.PRNGKey(10), rcfg)),
                                    device="cpu")
    feats, toks = _feats(2, 24, seed=11, width=16), _tokens((2, 20), seed=12, vocab=300)
    full, _ = p_encdec.forward(pp, feats, toks, pcfg)
    last, cache = p_encdec.prefill(pp, feats, toks[:, :19], pcfg)
    _close(last, full[:, 18].numpy(), DECODE)
    cache = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 20, 19)
    step, _ = p_encdec.decode_step(pp, toks[:, 19], cache, 19, pcfg)
    _close(step, full[:, 19].numpy(), DECODE)


def test_grow_cache_keeps_cross_kv_and_flash_stays_off_on_cpu(model):
    rcfg, pcfg, rp, pp = model
    feats, toks = _feats(2, 30, seed=5), _tokens((2, 12), seed=6)
    before = flash_attention.launches
    _l, cache = p_encdec.prefill(pp, feats, toks, pcfg)
    assert flash_attention.launches == before  # the CPU runs the plain version
    grown = p_engine._grow_cache(p_registry.get_model(pcfg), cache, 20, 12)
    assert grown.cross_k is cache.cross_k and grown.cross_v is cache.cross_v
    assert grown.self_kv.capacity == 20 and not grown.self_kv.v[:, :, 12:].any()
    _l, ref_cache = R_PREFILL(rp, jnp.asarray(feats), jnp.asarray(toks), rcfg, P)
    ref_grown = r_engine._grow_cache(r_registry.get_model(rcfg), ref_cache, 20, 12)
    _close(grown.self_kv.k, ref_grown.self_kv.k)


def test_init_draws_reference_layouts():
    rcfg, pcfg = r_configs.get_smoke_config(ARCH), p_configs.get_smoke_config(ARCH)
    ref = jax.eval_shape(lambda: r_encdec.init(jax.random.PRNGKey(0), rcfg))
    port = p_encdec.init(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), port
    ) == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref)
    with pytest.raises(ValueError, match="encdec"):
        p_encdec.init(torch.Generator(), dataclasses.replace(pcfg, family="dense"), device="cpu")
