"""The rest of the port's LM serving: ``ContinuousBatcher`` (re-pointed from
``tests/test_extensions.py::test_continuous_batcher_serves_mixed_requests``)
and multi-token attention over a KV cache, held against the JAX package.

Both packages get the same weights (the reference's ``init``, carried over
with ``params_from_reference``) and the same prompts.  Greedy tokens, wave
membership and step counts are equal exactly; attention outputs and the
written caches agree to fp32 2e-5 (the port's and the reference's products
and online softmax summed in other orders — the tolerance of
``tests/test_torch_transformer.py``).  The multi-token branch is held on a
linear cache, on a cache whose length is not a multiple of the config's
``attn_chunk`` (the reference's zero pad, masked), on a sliding-window ring
(including the write the reference clamps at the ring's end), and where a
window leaves query rows no key (the reference then averages every key,
pad included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import get_model as r_get_model
from repro.models import layers as r_layers
from repro.models import make_config as r_make_config
from repro.serving.batching import ContinuousBatcher as RBatcher
from repro.serving.batching import GenRequest as RGenRequest
from repro.sharding.policy import TP_POLICY
from repro_torch import configs as p_configs
from repro_torch.models import layers as p_layers
from repro_torch.models import multitask as p_mt
from repro_torch.models.config import make_config as p_make_config
from repro_torch.models.registry import get_model as p_get_model
from repro_torch.serving import ContinuousBatcher, GenRequest, GenResult, LMServer

FP32 = dict(rtol=2e-5, atol=2e-5)
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            param_dtype="float32", remat=False, attn_chunk=32, loss_chunk=16)


def _tiny_models():
    """The reference test's tiny model in both packages, one set of weights
    (``jax.random.PRNGKey(2)``, as there)."""
    rmodel = r_get_model(r_make_config(**TINY))
    pmodel = p_get_model(p_make_config(**TINY))
    rparams = rmodel.init(jax.random.PRNGKey(2))
    pparams = p_mt.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, pmodel, pparams


RMODEL, RPARAMS, PMODEL, PPARAMS = _tiny_models()


def _mixed_requests(cls, n=5):
    rng = np.random.default_rng(0)
    return [cls(uid=uid, prompt=rng.integers(0, 256, size=4 + uid).astype(np.int32),
                max_new_tokens=3 + (uid % 3)) for uid in range(n)]


def _serve(batcher, requests):
    for r in requests:
        batcher.submit(r)
    return batcher.run()


def test_continuous_batcher_serves_mixed_requests():
    results = _serve(ContinuousBatcher(PMODEL, PPARAMS, slots=2, max_len=64),
                     _mixed_requests(GenRequest))
    ref = _serve(RBatcher(RMODEL, RPARAMS, slots=2, max_len=64), _mixed_requests(RGenRequest))
    assert len(results) == 5
    assert sorted(r.uid for r in results) == list(range(5))
    for r in results:
        assert isinstance(r, GenResult)
        assert 1 <= r.steps <= 5
        assert r.tokens.shape[0] == r.steps
    assert [(r.uid, r.steps) for r in results] == [(r.uid, r.steps) for r in ref]
    for got, want in zip(results, ref):
        np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("slots", [1, 3])
def test_batcher_tokens_equal_generate_on_each_wave(slots):
    """Each request's tokens are ``LMServer.generate`` on its own wave's
    right-aligned, edge-padded prompts, cut to that request's steps."""
    reqs = _mixed_requests(GenRequest, 7)
    results = {r.uid: r for r in _serve(ContinuousBatcher(PMODEL, PPARAMS, slots=slots,
                                                          max_len=64), reqs)}
    server = LMServer(PMODEL, PPARAMS)
    for w in range(0, len(reqs), slots):
        wave = reqs[w:w + slots]
        toks = ContinuousBatcher.wave_tokens(wave)
        assert toks.shape == (len(wave), max(len(r.prompt) for r in wave))
        for i, r in enumerate(wave):
            assert (toks[i, -len(r.prompt):] == r.prompt).all()
            assert (toks[i, :toks.shape[1] - len(r.prompt)] == r.prompt[0]).all()
        gen = server.generate(toks, max(r.max_new_tokens for r in wave))
        for i, r in enumerate(wave):
            np.testing.assert_array_equal(results[r.uid].tokens, gen[i, :r.max_new_tokens])


def test_batcher_stops_at_eos_like_the_reference():
    free = _serve(ContinuousBatcher(PMODEL, PPARAMS, slots=2, max_len=64),
                  _mixed_requests(GenRequest))
    eos = int(free[2].tokens[1])     # request 2 emits it as its second token
    got = _serve(ContinuousBatcher(PMODEL, PPARAMS, slots=2, max_len=64, eos_token=eos),
                 _mixed_requests(GenRequest))
    ref = _serve(RBatcher(RMODEL, RPARAMS, slots=2, max_len=64, eos_token=eos),
                 _mixed_requests(RGenRequest))
    assert got[2].steps <= 2 and got[2].tokens[-1] == eos
    assert [(r.uid, r.steps) for r in got] == [(r.uid, r.steps) for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_batcher_rejects_requests_over_max_len():
    cb = ContinuousBatcher(PMODEL, PPARAMS, slots=2, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(GenRequest(uid=0, prompt=np.zeros(6, np.int32), max_new_tokens=3))


# --------------------------------------------------------------------------
# Multi-token attention over a KV cache
# --------------------------------------------------------------------------

# (cache slots T, cache_len, new tokens S, sliding window, attn_chunk)
CACHED_CASES = {
    "linear": (16, 4, 3, None, 64),
    "chunk_pad": (20, 5, 4, None, 8),          # 20 keys padded to 24
    "ring": (8, 11, 3, 8, 64),                 # slot 3 of an 8-slot ring
    "ring_clamped": (8, 14, 3, 8, 4),          # slot 6: the write clamps to 5
    "rows_without_keys": (16, 6, 6, 4, 8),     # queries 4+ past the window
}


@pytest.fixture(scope="module")
def attn_params():
    """One attention layer of the smoke mistral config, initialised once
    by the reference; window and chunk do not enter the weights."""
    cfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"), num_layers=1)
    rp = r_layers.init_attention(jax.random.PRNGKey(4), cfg)
    return rp, p_mt.params_from_reference(jax.tree_util.tree_map(np.asarray, rp),
                                          device="cpu")


@pytest.mark.parametrize("case", list(CACHED_CASES))
def test_multi_token_cached_attention_matches_reference(case, attn_params):
    t, cache_len, s, window, chunk = CACHED_CASES[case]
    kw = dict(num_layers=1, sliding_window=window, attn_chunk=chunk)
    rcfg = dataclasses.replace(r_configs.get_smoke_config("mistral-nemo-12b"), **kw)
    pcfg = dataclasses.replace(p_configs.get_smoke_config("mistral-nemo-12b"), **kw)
    rp, pp = attn_params
    rng = np.random.default_rng(len(case))
    shape = (2, t, pcfg.n_kv_heads, pcfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, s, pcfg.d_model)).astype(np.float32)
    pos = np.arange(cache_len, cache_len + s, dtype=np.int32)
    r_out, (r_ck, r_cv) = r_layers.attention_block(
        rp, jnp.asarray(x), rcfg,
        TP_POLICY, jnp.asarray(pos), kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(cache_len, jnp.int32))
    p_ck, p_cv = torch.as_tensor(ck), torch.as_tensor(cv)
    p_out, cache = p_layers.attention_block(
        pp, torch.as_tensor(x), pcfg,
        torch.as_tensor(pos), kv_cache=(p_ck, p_cv), cache_len=cache_len)
    assert cache[0] is p_ck and cache[1] is p_cv      # written in place
    np.testing.assert_allclose(p_out.numpy(), np.asarray(r_out), **FP32)
    np.testing.assert_allclose(p_ck.numpy(), np.asarray(r_ck), **FP32)
    np.testing.assert_allclose(p_cv.numpy(), np.asarray(r_cv), **FP32)


def test_attention_chunked_matches_reference_oracle():
    """The port's plain chunked attention against the reference's, on raw
    q/k/v: causal with a window, and non-causal with ``kv_valid`` and a
    chunk pad (where the reference lets nothing but ``kv_valid`` mask)."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    qp, kp = np.arange(8, 13, dtype=np.int32), np.arange(13, dtype=np.int32)
    valid = np.ones((2, 13), bool)
    valid[1, 9:] = False
    for causal, window, kv_valid in ((True, 6, None), (False, None, valid), (True, 3, valid)):
        ref = r_layers.attention_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp), jnp.asarray(kp),
            window=window, causal=causal, chunk=4,
            kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
        got = p_layers.attention_chunked(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(qp),
            torch.as_tensor(kp), window=window, causal=causal, chunk=4,
            kv_valid=None if kv_valid is None else torch.as_tensor(kv_valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)
