"""The port's LM training against the JAX package's.

The same weights (the reference's ``init``, carried over as numpy arrays),
the same token ids and the same optimizer state go through both packages:
the chunked loss, the schedule, AdamW, one train step of every arch's smoke
config (loss, lr, grad norm, every gradient leaf and the updated params),
gradient accumulation, ``lm_batches``, checkpoints written by one package
and restored by the other, and the train launcher.  Everything is fp32 on
the CPU, where the port's attention is the plain version under autograd.
Tolerances: losses, lrs and grad norms 2e-5 relative; a gradient leaf
within 1e-4 of that leaf's largest |value| (products and softmax summed in
other orders, the reference's attention its chunked oracle); params after
one AdamW step 2e-6 absolute (steps of at most lr = 1e-3 from equal params,
computed from those gradients) wherever the reference's |g| exceeds both
1e-6 and 1e-3 of the leaf's largest |g|.  AdamW's first step is about
sign(g): below 10x the gradient tolerance the two packages' values of an
element may differ in sign, and below 1e-6 the step g / (|g| + eps)
follows the gradient's own rounding (see
:func:`test_adamw_update_on_reference_grads`).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.data import lm_batches as r_lm_batches
from repro.models import get_model as r_get_model
from repro.models import make_config as r_make_config
from repro.sharding.policy import TP_POLICY
from repro.training import (
    AdamWConfig as RAdamWConfig, adamw_init as r_adamw_init, adamw_update as r_adamw_update,
    cross_entropy_chunked as r_ce, lm_loss as r_lm_loss, lr_at as r_lr_at,
    make_train_step as r_make_train_step, restore_checkpoint as r_restore,
    save_checkpoint as r_save,
)
from repro_torch import configs as p_configs
from repro_torch._device import tree_leaves
from repro_torch.data import lm_batches as p_lm_batches
from repro_torch.launch import train as p_train_launcher
from repro_torch.models import multitask as p_mt
from repro_torch.models.config import make_config as p_make_config
from repro_torch.models.registry import get_model as p_get_model
from repro_torch.training import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, cross_entropy_chunked, latest_checkpoint,
    loss_and_grads, lr_at, make_train_step, restore_checkpoint, save_checkpoint,
)

ARCHS = r_configs.list_archs()
SCALAR = dict(rtol=2e-5, atol=1e-6)
GRAD_REL = 1e-4
PARAM_ATOL = 2e-6
G_FLOOR = 1e-6  # |g| below which AdamW's first step is not compared


def _assert_params(ref_new, port_new, ref_grads, atol=PARAM_ATOL, rel_floor=10 * GRAD_REL):
    """Updated params equal where the reference's |g| exceeds
    :data:`G_FLOOR` and ``rel_floor`` of the leaf's largest |g|."""
    g = _leaves_by_path(ref_grads)
    want, got = _leaves_by_path(ref_new), _port_by_path(ref_new, port_new)
    for key, w in want.items():
        big = np.abs(g[key]) > max(G_FLOOR, rel_floor * float(np.abs(g[key]).max()))
        np.testing.assert_allclose(got[key][big], w[big], atol=atol, rtol=0, err_msg=key)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(ref_tree, port_tree):
    """The port's leaves keyed by the reference's paths (both trees flatten
    dicts in sorted-key order in the reference, insertion order in the
    port: match by path, not position)."""
    def get(t, path):
        for k in path:
            if hasattr(k, "key"):
                t = t[k.key]
            elif hasattr(k, "name"):
                t = getattr(t, k.name)
            else:
                t = t[k.idx]
        return t
    return {jax.tree_util.keystr(p): get(port_tree, p).detach().numpy()
            for p, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}


def _tiny(**kw):
    base = dict(name="tiny", family="dense", num_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=512, dtype="float32",
                param_dtype="float32", remat=False, attn_chunk=32, loss_chunk=16)
    base.update(kw)
    return r_make_config(**base), p_make_config(**base)


def _models(rcfg, pcfg, seed=0):
    rm, pm = r_get_model(rcfg), p_get_model(pcfg)
    rp = jax.jit(rm.init)(jax.random.PRNGKey(seed))  # compiled: faster than op by op
    return rm, pm, rp, p_mt.params_from_reference(_np_tree(rp), device="cpu")


def _batch(cfg, rng, batch=2, seq=32):
    tokens = rng.integers(0, cfg.raw_vocab_size, (batch, seq)).astype(np.int32)
    if cfg.family == "encdec":
        feats = rng.standard_normal((batch, seq, cfg.enc_inputs)).astype(np.float32)
        return {"features": feats, "tokens": tokens}
    return tokens


def _ref_batch(batch):
    if isinstance(batch, dict):
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return jnp.asarray(batch)


def _assert_grads(ref_grads, port_grads, rel=GRAD_REL):
    want = _leaves_by_path(ref_grads)
    got = _port_by_path(ref_grads, port_grads)
    assert want.keys() == got.keys()
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[key] - w).max())
        assert err <= rel * scale + 1e-9, f"{key}: max err {err} vs max |g| {scale}"


# --------------------------------------------------------------------------
# Re-pointed tests/test_training.py
# --------------------------------------------------------------------------

def test_chunked_ce_matches_dense():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 64, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (2, 64)).astype(np.int32)
    ce = cross_entropy_chunked(torch.tensor(logits), torch.tensor(labels), chunk=16)
    lp = torch.log_softmax(torch.tensor(logits).double(), dim=-1)
    dense = -torch.gather(lp, -1, torch.tensor(labels).long()[..., None]).mean()
    np.testing.assert_allclose(float(ce), float(dense), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(r_ce(jnp.asarray(logits), jnp.asarray(labels),
                                                     chunk=16)), rtol=1e-6)
    # A ragged length falls back to one chunk, as the reference does.
    ragged = cross_entropy_chunked(torch.tensor(logits[:, :63]), torch.tensor(labels[:, :63]),
                                   chunk=16)
    np.testing.assert_allclose(
        float(ragged), float(r_ce(jnp.asarray(logits[:, :63]), jnp.asarray(labels[:, :63]),
                                  chunk=16)), rtol=1e-6)


def test_loss_decreases_over_steps():
    """40 AdamW steps from the reference's weights on its token stream: the
    port's loss falls as the reference's does, step for step within 1e-3
    (AdamW's normalised steps let fp32 differences of the gradients grow a
    little over the run)."""
    rcfg, pcfg = _tiny()
    rm, pm, rp, pp = _models(rcfg, pcfg)
    opt_cfg = dict(lr=2e-3, warmup_steps=5, total_steps=100)
    r_step = jax.jit(r_make_train_step(rm, RAdamWConfig(**opt_cfg), TP_POLICY))
    p_step = make_train_step(pm, AdamWConfig(**opt_cfg))
    r_opt, p_opt = r_adamw_init(rp), adamw_init(pp)
    it = p_lm_batches(pcfg.vocab_size, batch=8, seq_len=64, seed=0)
    r_losses, p_losses = [], []
    for _ in range(40):
        tokens = next(it)
        rp, r_opt, rm_ = r_step(rp, r_opt, jnp.asarray(tokens))
        pp, p_opt, pm_ = p_step(pp, p_opt, tokens)
        r_losses.append(float(rm_["loss"]))
        p_losses.append(float(pm_["loss"]))
    assert p_losses[-1] < p_losses[0] - 0.2
    assert np.isfinite(p_losses).all()
    np.testing.assert_allclose(p_losses, r_losses, rtol=1e-3)


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert lr_at(cfg, 0) == 0.0
    np.testing.assert_allclose(lr_at(cfg, 10), 1.0, rtol=1e-5)
    assert lr_at(cfg, 100) <= 0.1 + 1e-6
    vals = [lr_at(cfg, s) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    rcfg = RAdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for schedule in ("cosine", "constant"):
        pc = dataclasses.replace(cfg, schedule=schedule)
        rc = dataclasses.replace(rcfg, schedule=schedule)
        for s in range(0, 121, 7):
            np.testing.assert_allclose(lr_at(pc, s), float(r_lr_at(rc, jnp.asarray(s))),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_moves_params_and_decays_weights():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    grads = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10,
                      schedule="constant", clip_norm=None)
    new, st2, _ = adamw_update(cfg, grads, adamw_init(params), params)
    # zero grads: matrices shrink via decoupled decay, vectors untouched
    assert float(new["w"][0, 0]) < 1.0
    np.testing.assert_allclose(new["b"].numpy(), 0.0)
    assert int(st2.step) == 1
    assert float(params["w"][0, 0]) == 1.0  # the caller's params are not updated in place
    rnew, _, _ = r_adamw_update(
        RAdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0, total_steps=10,
                     schedule="constant", clip_norm=None),
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        r_adamw_init({k: jnp.asarray(v.numpy()) for k, v in params.items()}),
        {k: jnp.asarray(v.numpy()) for k, v in params.items()})
    for k in params:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(rnew[k]), atol=1e-7)


def test_checkpoint_roundtrip(tmp_path):
    rcfg, pcfg = _tiny()
    _rm, _pm, _rp, pp = _models(rcfg, pcfg, seed=3)
    path = os.path.join(tmp_path, "ckpt_10.npz")
    tree = {"params": pp, "opt": adamw_init(pp), "bf16": pp["final_norm"]["scale"].bfloat16()}
    save_checkpoint(path, tree, step=10)
    restored, step = restore_checkpoint(path, tree)
    assert step == 10
    assert isinstance(restored["opt"], AdamWState)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_checkpoint(os.path.join(tmp_path, "ckpt_2.npz"), tree, step=2)
    assert latest_checkpoint(str(tmp_path)) == path
    assert latest_checkpoint(os.path.join(tmp_path, "none")) is None


# --------------------------------------------------------------------------
# One train step of every arch (re-pointed tests/test_smoke_archs.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """One step of each smoke config from the reference's weights: loss, lr,
    grad norm, every gradient leaf and every updated param.  The reference's
    step is its own ``grads_of`` + ``adamw_update`` composition, with the
    loss and gradients jitted once per arch."""
    rcfg, pcfg = r_configs.get_smoke_config(arch), p_configs.get_smoke_config(arch)
    rm, pm, rp, pp = _models(rcfg, pcfg)
    batch = _batch(pcfg, np.random.default_rng(0))
    opt_cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)

    r_grad = jax.jit(jax.value_and_grad(
        lambda p, b: r_lm_loss(rm, p, b, TP_POLICY), has_aux=True))
    (r_loss, _parts), r_grads = r_grad(rp, _ref_batch(batch))
    r_new, r_opt, r_metrics = jax.jit(functools.partial(r_adamw_update, RAdamWConfig(**opt_cfg)))(
        r_grads, r_adamw_init(rp), rp)

    loss, _parts, grads = loss_and_grads(pm, pp, batch)
    np.testing.assert_allclose(float(loss), float(r_loss), **SCALAR)
    _assert_grads(r_grads, grads)

    new, opt, metrics = make_train_step(pm, AdamWConfig(**opt_cfg))(pp, adamw_init(pp), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(opt.step) == 1 == int(r_opt.step)
    np.testing.assert_allclose(float(metrics["loss"]), float(r_loss), **SCALAR)
    np.testing.assert_allclose(metrics["lr"], float(r_metrics["lr"]), **SCALAR)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(r_metrics["grad_norm"]),
                               **SCALAR)
    _assert_params(r_new, new, r_grads)
    deltas = [float((a - b).abs().max()) for a, b in zip(tree_leaves(pp), tree_leaves(new))]
    assert max(deltas) > 0.0


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` recomputes each layer body in the backward
    (``torch.utils.checkpoint``): the gradients are those without it, bit
    for bit on the CPU."""
    _rcfg, pcfg = _tiny()
    rcfg_r, pcfg_r = _tiny(remat=True)
    _rm, pm, _rp, pp = _models(rcfg_r, pcfg)
    batch = _batch(pcfg, np.random.default_rng(1))
    loss, _, grads = loss_and_grads(pm, pp, batch)
    loss_r, _, grads_r = loss_and_grads(p_get_model(pcfg_r), pp, batch)
    assert torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# Gradient accumulation (re-pointed tests/test_extensions.py)
# --------------------------------------------------------------------------

def test_grad_accumulation_matches_full_batch():
    rcfg, pcfg = _tiny(vocab_size=256)
    rm, pm, rp, pp = _models(rcfg, pcfg)
    batch = np.random.default_rng(1).integers(0, 256, (8, 32)).astype(np.int32)
    opt_cfg = dict(lr=1e-3, warmup_steps=0, total_steps=10, schedule="constant",
                   clip_norm=None)
    p1, _, m1 = make_train_step(pm, AdamWConfig(**opt_cfg), grad_accum=1)(
        pp, adamw_init(pp), batch)
    p4, _, m4 = make_train_step(pm, AdamWConfig(**opt_cfg), grad_accum=4)(
        pp, adamw_init(pp), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
    r4 = jax.jit(r_make_train_step(rm, RAdamWConfig(**opt_cfg), TP_POLICY, grad_accum=4))
    rp4, _, rm4 = r4(rp, r_adamw_init(rp), jnp.asarray(batch))
    np.testing.assert_allclose(float(m4["loss"]), float(rm4["loss"]), **SCALAR)
    r_grads = jax.jit(jax.grad(lambda p: r_lm_loss(rm, p, jnp.asarray(batch), TP_POLICY)[0]))(rp)
    _assert_params(rp4, p4, r_grads)


# --------------------------------------------------------------------------
# AdamW on the reference's gradients
# --------------------------------------------------------------------------

def test_adamw_update_on_reference_grads():
    """The port's AdamW fed the reference's gradients and state: the same
    params to 1e-6, wherever the reference's |g| exceeds 1e-6.  Below that
    floor the first step's g / (|g| + eps) (eps = 1e-8) is no longer about
    sign(g): it moves by about eps / |g| of itself for a relative change
    in the clipped gradient, and the two packages' clip scales come from
    norms summed in other orders.  The moments are compared everywhere."""
    rcfg, pcfg = _tiny()
    rm, _pm, rp, pp = _models(rcfg, pcfg)
    tokens = jnp.asarray(next(r_lm_batches(rcfg.vocab_size, 4, 32, seed=0)))
    r_grads = jax.grad(lambda p: r_lm_loss(rm, p, tokens, TP_POLICY)[0])(rp)
    opt_cfg = dict(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=0.5)
    r_state = r_adamw_init(rp)
    p_state = p_mt.adamw_state_from_reference(_np_tree(r_state), device="cpu")
    p_grads = p_mt.params_from_reference(_np_tree(r_grads), device="cpu")
    r_update = jax.jit(functools.partial(r_adamw_update, RAdamWConfig(**opt_cfg)))
    for _step in range(2):
        r_new, r_state, r_m = r_update(r_grads, r_state, rp)
        p_new, p_state, p_m = adamw_update(AdamWConfig(**opt_cfg), p_grads, p_state, pp)
        np.testing.assert_allclose(float(p_m["grad_norm"]), float(r_m["grad_norm"]), rtol=1e-6)
        _assert_params(r_new, p_new, r_grads, atol=1e-6, rel_floor=0.0)
        for r_t, p_t in ((r_state.mu, p_state.mu), (r_state.nu, p_state.nu)):
            want, got = _leaves_by_path(r_t), _port_by_path(r_t, p_t)
            for key, w in want.items():
                np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-12, err_msg=key)
        assert int(p_state.step) == int(r_state.step)
        rp, pp = r_new, p_new


# --------------------------------------------------------------------------
# Data and checkpoints across the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [(1024, 4, 32, 0), (131072, 2, 17, 3)])
def test_lm_batches_bit_equal(vocab, batch, seq, seed):
    r_it, p_it = r_lm_batches(vocab, batch, seq, seed=seed), p_lm_batches(vocab, batch, seq,
                                                                          seed=seed)
    for _ in range(3):
        a, b = next(r_it), next(p_it)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint of params and AdamW state written by the reference
    restores in the port, bf16 leaves included, and the port's restores in
    the reference.  A bf16 leaf is written by both as raw 2-byte values
    (numpy's ``V2``): the port's file holds the reference's bytes, and the
    port reads them back bit for bit; the reference's own restore cannot
    cast ``V2`` to bf16, so its side is checked on fp32 trees."""
    rcfg, pcfg = _tiny()
    _rm, _pm, rp, pp = _models(rcfg, pcfg, seed=2)
    r_tree = {"params": rp, "opt": r_adamw_init(rp)}
    p_tree = {"params": pp, "opt": adamw_init(pp)}
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    r_save(ref_path, r_tree, step=7)
    restored, step = restore_checkpoint(ref_path, p_tree)
    assert step == 7
    for key, w in _leaves_by_path(r_tree).items():
        assert np.array_equal(_port_by_path(r_tree, restored)[key], w), key
    save_checkpoint(port_path, p_tree, step=9)
    r_restored, r_step = r_restore(port_path, r_tree)
    assert r_step == 9
    for key, w in _leaves_by_path(r_tree).items():
        assert np.array_equal(np.asarray(_leaves_by_path(r_restored)[key]), w), key

    # bf16: the reference's file restores in the port bit for bit, and the
    # port's file holds the same arrays.
    r_bf = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), rp)
    p_bf = p_mt.params_from_reference(_np_tree(r_bf), device="cpu")
    r_save(ref_path, r_bf, step=1)
    save_checkpoint(port_path, p_bf, step=1)
    got, _ = restore_checkpoint(ref_path, p_bf)
    for a, b in zip(tree_leaves(p_bf), tree_leaves(got)):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    with np.load(ref_path) as ra, np.load(port_path) as pa:
        assert sorted(ra.files) == sorted(pa.files)
        for k in ra.files:
            assert ra[k].dtype.itemsize == pa[k].dtype.itemsize
            assert ra[k].tobytes() == pa[k].tobytes(), k


# --------------------------------------------------------------------------
# The train launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "whisper-medium"])
def test_train_launcher_matches_reference_losses(arch, capsys, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu`` from the reference's ``init(PRNGKey(0))`` weights: each step's
    loss, lr and grad norm are the reference launcher's loop's (its
    schedule, ``lm_batches(seed=0)`` and, for whisper, ``default_rng(step)``
    features), its step lines are printed, and ``--ckpt`` saves the final
    params, which the reference restores."""
    steps, batch, seq = 3, 2, 32
    rcfg, pcfg = r_configs.get_smoke_config(arch), p_configs.get_smoke_config(arch)
    rm, _pm, rp, pp = _models(rcfg, pcfg)
    opt_cfg = RAdamWConfig(lr=3e-4, warmup_steps=max(steps // 10, 1), total_steps=steps)
    r_step = jax.jit(r_make_train_step(rm, opt_cfg, TP_POLICY))
    r_opt = r_adamw_init(rp)
    it = r_lm_batches(rcfg.vocab_size, batch, seq, seed=0)
    want = []
    for step in range(steps):
        tokens = jnp.asarray(next(it))
        if rcfg.family == "encdec":
            feats = jnp.asarray(np.random.default_rng(step).normal(
                size=(batch, seq, rcfg.enc_inputs)).astype(np.float32))
            b = {"features": feats, "tokens": tokens}
        else:
            b = tokens
        rp, r_opt, m = r_step(rp, r_opt, b)
        want.append({k: float(m[k]) for k in ("loss", "lr", "grad_norm")})
    ckpt = str(tmp_path / f"ckpt_{steps}.npz")
    out = p_train_launcher.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", str(steps),
         "--batch", str(batch), "--seq", str(seq), "--ckpt", ckpt], params=pp)
    for got, w in zip(out["history"], want):
        for k in w:
            np.testing.assert_allclose(got[k], w[k], rtol=1e-4, err_msg=k)
    text = capsys.readouterr().out
    assert "step    0 loss" in text and "tok/s" in text and f"saved {ckpt}" in text
    restored, step = r_restore(ckpt, {"params": rp})
    assert step == steps
    want, got = _leaves_by_path(restored), _port_by_path(restored, {"params": out["params"]})
    for key, w in want.items():
        assert np.array_equal(np.asarray(w), got[key]), key


def test_train_launcher_refuses_the_production_mesh():
    """``--production-mesh`` in a world of one rank raises ``make_mesh``'s
    error, which names the 256 ranks the 16 x 16 mesh needs, and the world
    of one the launcher made is gone."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="needs a world of 256 ranks; this world has 1"):
        p_train_launcher.main(["--arch", "mistral-nemo-12b", "--smoke", "--device", "cpu",
                               "--production-mesh"])
    assert not dist.is_initialized()
