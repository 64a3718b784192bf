"""The port's two reference examples against the JAX package's.

``repro_torch.examples.train_multitask`` (Antler's retraining of the task
graph) runs on a 4-layer smoke transformer program converted from the
reference's (one layer per block of the example's 4-level graph): the
joint loss and every gradient leaf against ``jax.value_and_grad`` of the
reference's ``multitask_loss``, and a few AdamW steps' losses against the
reference's jitted ``train_step``, at the training tolerances of
``tests/test_torch_training.py`` (loss 2e-5 relative, a gradient leaf 1e-4
of its largest |value|, the steps' losses 1e-3 relative).

``repro_torch.examples.serve_multitask``'s four segments run on the
reference's weights and data: the audio deployment (tasks run and gated
off, Antler's and Vanilla's modelled ms and mJ), the affinity session
(groups, rounds, ``stats == predicted``), the adaptive arms (block-rows
gated, speedup, ``stats == predicted``) and the LM server's tokens, each
held to the reference's segment, written out here from
``examples/serve_multitask.py``.  Everything is fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_get_smoke_config
from repro.core import (
    MSP430 as R_MSP430, TPU_V5E as R_TPU_V5E, BlockCost as RBlockCost,
    Constraints as RConstraints, GraphCostModel as RGraphCostModel,
    MultitaskProgram as RMultitaskProgram, VanillaExecutor as RVanillaExecutor,
    optimal_order as r_optimal_order,
)
from repro.core.task_graph import TaskGraph as RTaskGraph
from repro.data import MultitaskDataset as RMultitaskDataset
from repro.data import lm_batches as r_lm_batches
from repro.models import get_model as r_get_model
from repro.models import make_config as r_make_config
from repro.models import multitask as r_mt
from repro.serving import (
    AdaptivePolicy as RAdaptivePolicy, AffinityPolicy as RAffinityPolicy,
    EnginePolicy as REnginePolicy, LMServer as RLMServer, MultitaskEngine as RMultitaskEngine,
    MultitaskRequest as RMultitaskRequest,
)
from repro.training.optimizer import (
    AdamWConfig as RAdamWConfig, adamw_init as r_adamw_init, adamw_update as r_adamw_update,
)
from repro_torch._device import tree_leaves
from repro_torch.core import MSP430, TaskGraph
from repro_torch.data import MultitaskDataset
from repro_torch.examples import serve_multitask as serve
from repro_torch.examples import train_multitask as train
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import multitask as p_mt
from repro_torch.models.registry import get_model

SMALL = dict(num_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
             attn_chunk=16, loss_chunk=16)
SEQ, BATCH, STEPS = 32, 4, 5
LOSS_REL, GRAD_REL, STEPS_REL = 2e-5, 1e-4, 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(ref_tree, port_tree):
    def get(t, path):
        for k in path:
            t = t[k.key] if hasattr(k, "key") else t[k.idx]
        return t
    return {jax.tree_util.keystr(p): get(port_tree, p).detach().numpy()
            for p, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]}


# --------------------------------------------------------------------------
# train_multitask
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def programs():
    """The reference's smoke program of the example's graph and the port's
    with its weights (the example's backbone config, shrunk)."""
    fields = dict(name="granite-100m", family="dense", dtype="float32",
                  param_dtype="float32", remat=False, **SMALL)
    rcfg = r_make_config(**fields)
    pcfg = train.backbone_config(**SMALL)
    rgraph = RTaskGraph.from_groups([list(g) for g in train.GRAPH_GROUPS])
    ref = r_mt.build_transformer_program(jax.random.PRNGKey(0), rgraph, rcfg,
                                         list(train.N_CLASSES), seq_len=SEQ)
    port = p_mt.transformer_program_from_reference(
        train.task_graph(), pcfg, _np_tree(ref.node_params), _np_tree(ref.head_params),
        SEQ, device="cpu")
    return ref, port, pcfg


def _ref_loss_fn(ref):
    def loss_fn(f, x, labels):
        return r_mt.multitask_loss(ref, f, x, labels)
    return loss_fn


def test_train_example_graph_order_and_size(programs):
    ref, port, _cfg = programs
    assert port.graph.partitions == ref.graph.partitions
    ref_order = r_optimal_order(
        RGraphCostModel(ref.graph, ref.block_costs, R_TPU_V5E).cost_matrix()).order
    assert train.serving_order(port) == list(ref_order)
    flat = p_mt.program_trainable_params(port)
    assert sum(t.numel() for t in tree_leaves(flat)) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(r_mt.program_trainable_params(ref)))
    tokens = next(r_lm_batches(512, BATCH, SEQ, seed=0))
    labels = train.task_labels(tokens)
    assert labels.shape == (4, BATCH) and labels.dtype == np.int32
    for t, c in enumerate(train.N_CLASSES):
        np.testing.assert_array_equal(labels[t], tokens[:, -(t + 1)] % c)


def test_train_example_loss_and_every_gradient_match_the_reference(programs):
    ref, port, _cfg = programs
    tokens = next(r_lm_batches(512, BATCH, SEQ, seed=0))
    labels = train.task_labels(tokens)
    r_flat = r_mt.program_trainable_params(ref)
    r_loss, r_grads = jax.jit(jax.value_and_grad(_ref_loss_fn(ref)))(
        r_flat, jnp.asarray(tokens), jnp.asarray(labels))
    before = flash_attention.backward_launches
    loss, grads = train.loss_and_grads(
        port, p_mt.program_trainable_params(port), torch.as_tensor(tokens),
        torch.as_tensor(labels))
    assert flash_attention.backward_launches == before  # the CPU: the plain version
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_REL, atol=1e-6)
    want, got = _leaves_by_path(_np_tree(r_grads)), _port_by_path(r_grads, grads)
    assert want.keys() == got.keys()
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(got[key] - w).max()) <= GRAD_REL * scale, key
    # The backbone's unembedding is not read by the task heads: zero in both.
    unembed = [k for k in want if "unembed" in k]
    assert unembed and all(not np.any(got[k]) and not np.any(want[k]) for k in unembed)


def test_train_example_steps_match_the_reference_train_step(programs):
    ref, port, _cfg = programs
    opt_cfg = RAdamWConfig(lr=train.LR, warmup_steps=train.WARMUP, total_steps=STEPS)
    loss_fn = _ref_loss_fn(ref)

    @jax.jit
    def train_step(f, opt, x, labels):
        loss, grads = jax.value_and_grad(loss_fn)(f, x, labels)
        f, opt, m = r_adamw_update(opt_cfg, grads, opt, f)
        return f, opt, loss, m["grad_norm"]

    flat = r_mt.program_trainable_params(ref)
    opt = r_adamw_init(flat)
    it = r_lm_batches(512, batch=BATCH, seq_len=SEQ, seed=0)
    r_losses, r_norms = [], []
    for _ in range(STEPS):
        tokens = next(it)
        labels = np.stack([tokens[:, -(t + 1)] % c
                           for t, c in enumerate(train.N_CLASSES)]).astype(np.int32)
        flat, opt, loss, gnorm = train_step(flat, opt, jnp.asarray(tokens), jnp.asarray(labels))
        r_losses.append(float(loss))
        r_norms.append(float(gnorm))
    out = train.train(port, 512, STEPS, BATCH, SEQ, log=None)
    p_losses = [h["loss"] for h in out["history"]]
    p_norms = [h["grad_norm"] for h in out["history"]]
    assert np.isfinite(p_losses).all()
    np.testing.assert_allclose(p_losses, r_losses, rtol=STEPS_REL)
    np.testing.assert_allclose(p_norms, r_norms, rtol=STEPS_REL)
    assert int(out["opt"].step) == STEPS


# --------------------------------------------------------------------------
# serve_multitask: the reference's segments, as examples/serve_multitask.py
# runs them
# --------------------------------------------------------------------------

def _r_audio_segment(prog, ds):
    def presence_gate(outputs):
        return bool(jnp.argmax(outputs[0][0]) == 1)

    cons = RConstraints.make(5, conditional=[(0, t, 0.8) for t in range(1, 5)])
    engine = RMultitaskEngine(prog, constraints=cons, hw=R_MSP430,
                              gates={t: presence_gate for t in range(1, 5)})
    total_ant = total_en = 0.0
    ran = skipped = 0
    for _ in range(serve.N_REQUESTS):
        x, _ = ds.sample(1)
        resp = engine.serve(RMultitaskRequest(x=jnp.asarray(x)))
        total_ant += resp.predicted_seconds
        total_en += resp.stats.energy(R_MSP430)
        ran += resp.stats.tasks_run
        skipped += resp.stats.tasks_skipped
        engine.executor.reset()
    van = RVanillaExecutor(prog)
    t_van = e_van = 0.0
    for _ in range(serve.N_REQUESTS):
        x, _ = ds.sample(1)
        _, s = van.run(jnp.asarray(x), list(range(5)))
        t_van += s.seconds(R_MSP430)
        e_van += s.energy(R_MSP430)
    return {"order": list(engine.order), "tasks_run": ran, "tasks_gated_off": skipped,
            "antler_ms": total_ant * 1e3, "antler_mj": total_en * 1e3,
            "vanilla_ms": t_van * 1e3, "vanilla_mj": e_van * 1e3}


def _r_session_segment(prog, ds):
    engine = RMultitaskEngine(prog, hw=R_MSP430, policy=REnginePolicy(
        scheduling=RAffinityPolicy(max_group_size=4, max_wait=0.05),
        resolve_order_per_plan=True))
    session = engine.session()
    futures = [session.submit(RMultitaskRequest(x=jnp.asarray(ds.sample(1)[0]), tasks=s))
               for s in serve.SESSION_SUBSETS]
    session.drain()
    first = futures[0].result()
    return {"groups": session.groups_executed, "rounds": session.admission_rounds,
            "stats_equal_predicted": session.stats == session.predicted,
            "first_effective_order": list(first.effective_order),
            "first_order": list(first.order),
            "weight_bytes_loaded": session.stats.weight_bytes_loaded,
            "weight_bytes_skipped": session.stats.weight_bytes_skipped}


def _r_adaptive_segment(graph):
    dim, rng = 32, np.random.default_rng(2)

    def res_block(p, h):
        return h + jnp.tanh(h @ p) * jnp.maximum(0.0, 1.0 - jnp.mean(jnp.abs(h)))

    prog = RMultitaskProgram(
        graph, [res_block] * graph.depth,
        {n: jnp.asarray(rng.normal(size=(dim, dim)) / np.sqrt(dim), jnp.float32)
         for n in graph.nodes()},
        [lambda p, h: h @ p] * 5,
        [jnp.asarray(rng.normal(size=(dim, 4)), jnp.float32)] * 5,
        [RBlockCost(weight_bytes=4.0 * dim * dim, flops=2.0 * dim * dim)
         for _ in range(graph.depth)],
    )
    xs = [jnp.asarray(rng.normal(size=(dim,)) * (2.0 if i % 10 < 7 else 0.2), jnp.float32)
          for i in range(24)]
    arms = {}
    for name, adaptive in (("floor", None),
                           ("adaptive", RAdaptivePolicy(threshold=0.9, calibrate_online=True))):
        s = RMultitaskEngine(prog, hw=R_MSP430, policy=REnginePolicy(adaptive=adaptive)).session()
        for x in xs:
            s.submit(RMultitaskRequest(x=x))
        s.drain()
        arms[name] = s
    floor, ad = arms["floor"], arms["adaptive"]
    return {"block_rows_gated": ad.stats.block_rows_gated, "flops_gated": ad.stats.flops_gated,
            "speedup": floor.stats.seconds(R_MSP430) / ad.stats.seconds(R_MSP430),
            "stats_equal_predicted": ad.stats == ad.predicted,
            "expected_flops": ad.expected.flops_executed,
            "realized_flops": ad.stats.flops_executed}


@pytest.fixture(scope="module")
def audio_programs():
    graph = RTaskGraph.from_groups([
        [[0, 1, 2, 3, 4]], [[0], [1, 2, 3, 4]], [[0], [1, 2], [3, 4]],
        [[0], [1], [2], [3], [4]],
    ])
    ref = r_mt.build_cnn_program(jax.random.PRNGKey(0), graph, list(serve.AUDIO_CLASSES))
    port = p_mt.program_from_reference(
        TaskGraph(graph.num_tasks, graph.partitions),
        _np_tree(ref.node_params), _np_tree(ref.head_params), device="cpu")
    assert port.graph.partitions == serve.audio_graph().partitions
    return ref, port


def _same(got, want, keys, rel=1e-6):
    for k in keys:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=rel, err_msg=k)
        else:
            assert got[k] == want[k], (k, got[k], want[k])


def test_serve_example_audio_and_session_segments_match_the_reference(audio_programs):
    """The audio segment and then the session on the same dataset stream,
    as the example runs them: every counter equal, modelled ms and mJ to
    1e-6 relative (the same counters through the same cost model)."""
    ref, port = audio_programs
    r_ds = RMultitaskDataset(num_tasks=5, num_classes=2, seed=1)
    p_ds = MultitaskDataset(num_tasks=5, num_classes=2, seed=1)
    want = _r_audio_segment(ref, r_ds)
    got = serve.audio_segment(port, p_ds)
    _same(got, want, ("order", "tasks_run", "tasks_gated_off", "antler_ms", "antler_mj",
                      "vanilla_ms", "vanilla_mj"))
    assert got["reduction"] > 1.0
    want = _r_session_segment(ref, r_ds)
    got = serve.session_segment(port, p_ds)
    assert got["requests"] == len(serve.SESSION_SUBSETS)
    assert got["stats_equal_predicted"] and want["stats_equal_predicted"]
    _same(got, want, ("groups", "rounds", "first_effective_order", "first_order",
                      "weight_bytes_loaded", "weight_bytes_skipped"))


def test_serve_example_adaptive_segment_matches_the_reference():
    """The damped-residual program drawn from the same numpy stream in both
    packages: block-rows and flops gated, the speedup over the floor and
    the expected flops equal; executed counters equal the replayed
    prediction."""
    graph = RTaskGraph.from_groups([
        [[0, 1, 2, 3, 4]], [[0], [1, 2, 3, 4]], [[0], [1, 2], [3, 4]],
        [[0], [1], [2], [3], [4]],
    ])
    want = _r_adaptive_segment(graph)
    got = serve.adaptive_segment(*serve.adaptive_program(torch.device("cpu")))
    assert got["stats_equal_predicted"] and want["stats_equal_predicted"]
    assert got["block_rows_gated"] > 0
    _same(got, want, ("block_rows_gated", "flops_gated", "speedup", "expected_flops",
                      "realized_flops"))


def test_serve_example_lm_segment_generates_the_reference_tokens():
    """``LMServer.generate`` on the reduced granite-34b config with the
    reference's weights: the same 4 x 16 greedy tokens."""
    cfg = r_get_smoke_config(serve.LM_ARCH)
    rmodel = r_get_model(cfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(1))
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.raw_vocab_size, (serve.LM_BATCH, serve.LM_PROMPT)), jnp.int32)
    want = np.asarray(RLMServer(rmodel, rparams).generate(prompts, steps=serve.LM_STEPS))
    from repro_torch.configs import get_smoke_config

    model = get_model(get_smoke_config(serve.LM_ARCH))
    got = serve.lm_segment(model, p_mt.params_from_reference(_np_tree(rparams), device="cpu"))
    assert got["tokens"].shape == (serve.LM_BATCH, serve.LM_STEPS)
    np.testing.assert_array_equal(got["tokens"], want)


def test_serve_example_main_runs_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "reduction:" in text and "executed == predicted counters: True" in text
    assert out["audio"]["reduction"] > 1.0 and out["session"]["stats_equal_predicted"]
    assert out["lm"]["tokens"].shape == (serve.LM_BATCH, serve.LM_STEPS)
    assert MSP430.name == R_MSP430.name
