"""Serving example: the paper's real-world deployments (§7) as an engine,
the PyTorch port of ``examples/serve_multitask.py`` (no JAX needed).

1. The audio deployment's structure: 5 tasks (presence detection, command
   detection, speaker id, emotion, distance) where presence detection is a
   CONDITIONAL prerequisite — the other four run only when a speaker is
   present (80% of requests in the paper).  Requests stream through
   Antler's ``MultitaskEngine``; ``VanillaExecutor`` serves the same stream,
   and the modelled time and energy on the MSP430 are compared (paper:
   2.7-3.1x).
2. The same program served session-first under ``AffinityPolicy``.
3. Input-adaptive serving: a damped-residual program whose refinements
   vanish on easy inputs, the all-blocks floor against confidence gating.
4. ``LMServer`` on the reduced granite-34b config: prefill and KV-cached
   greedy decode (on CUDA the prefill runs the flash kernel).

Each segment is a function of its program, params and data, so the same
weights can be served by both packages.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_multitask [--device cpu]
(the default device is ``cuda``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    MSP430, BlockCost, Constraints, MultitaskProgram, TaskGraph, VanillaExecutor,
)
from repro_torch.data import MultitaskDataset
from repro_torch.models.multitask import build_cnn_program
from repro_torch.models.registry import ModelApi, get_model
from repro_torch.serving import (
    AdaptivePolicy, AffinityPolicy, EnginePolicy, LMServer, MultitaskEngine, MultitaskRequest,
)

TASKS = ["presence", "command", "speaker_id", "emotion", "distance"]
AUDIO_CLASSES = (2, 11, 5, 3, 2)
N_REQUESTS = 32
# An adversarial arrival order for the session: the light presence-only
# probe alternates with heavy full requests.
SESSION_SUBSETS = [(0,), None, (0, 1, 2), None, (0,), (3, 4), None, (1, 2)] * 2
ADAPTIVE_DIM, ADAPTIVE_REQUESTS = 32, 24
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "granite-34b", 4, 12, 16


def audio_graph() -> TaskGraph:
    """Fig. 14's graph: presence branches early; the heavier classifiers
    share two more blocks before splitting."""
    return TaskGraph.from_groups([
        [[0, 1, 2, 3, 4]],
        [[0], [1, 2, 3, 4]],
        [[0], [1, 2], [3, 4]],
        [[0], [1], [2], [3], [4]],
    ])


def audio_constraints() -> Constraints:
    """Presence (task 0) is a conditional prerequisite of the other four,
    which run in 80% of requests."""
    return Constraints.make(5, conditional=[(0, t, 0.8) for t in range(1, 5)])


def build_audio_program(device: torch.device, seed: int = 0) -> MultitaskProgram:
    return build_cnn_program(audio_graph(), list(AUDIO_CLASSES),
                             generator=torch.Generator().manual_seed(seed), device=device)


def presence_gate(outputs: Dict[int, torch.Tensor]) -> bool:
    """Tasks 1-4 run when the presence head says "present"."""
    return bool(torch.argmax(outputs[0][0]) == 1)


def audio_segment(program: MultitaskProgram, ds: MultitaskDataset,
                  n_requests: int = N_REQUESTS) -> Dict[str, Any]:
    """``n_requests`` gated requests through Antler's engine, one at a time
    (the executor reset between inputs), then as many through Vanilla, all
    drawn from ``ds``; modelled ms and mJ on the MSP430."""
    device = program.device
    engine = MultitaskEngine(program, constraints=audio_constraints(), hw=MSP430,
                             gates={t: presence_gate for t in range(1, 5)})
    antler_s = antler_j = 0.0
    ran = skipped = 0
    for _ in range(n_requests):
        x, _labels = ds.sample(1)
        resp = engine.serve(MultitaskRequest(x=torch.as_tensor(x, device=device)))
        antler_s += resp.predicted_seconds
        antler_j += resp.stats.energy(MSP430)
        ran += resp.stats.tasks_run
        skipped += resp.stats.tasks_skipped
        engine.executor.reset()  # a new input: the caches are invalid
    # Vanilla: every task at full cost, no gating.
    vanilla = VanillaExecutor(program)
    vanilla_s = vanilla_j = 0.0
    with torch.no_grad():
        for _ in range(n_requests):
            x, _labels = ds.sample(1)
            _outs, stats = vanilla.run(torch.as_tensor(x, device=device), list(range(5)))
            vanilla_s += stats.seconds(MSP430)
            vanilla_j += stats.energy(MSP430)
    return {
        "order": list(engine.order), "tasks_run": ran, "tasks_gated_off": skipped,
        "antler_ms": antler_s * 1e3, "antler_mj": antler_j * 1e3,
        "vanilla_ms": vanilla_s * 1e3, "vanilla_mj": vanilla_j * 1e3,
        "reduction": vanilla_s / antler_s, "energy_saving": 1.0 - antler_j / vanilla_j,
    }


def session_segment(program: MultitaskProgram, ds: MultitaskDataset,
                    subsets: Sequence[Any] = SESSION_SUBSETS) -> Dict[str, Any]:
    """The same program served session-first: requests ``submit()`` and
    return futures; ``AffinityPolicy`` admits the pending subset bucket that
    is cheapest to resume from the executor's residency, and each plan
    re-solves its group's order for that residency."""
    device = program.device
    engine = MultitaskEngine(program, hw=MSP430, policy=EnginePolicy(
        scheduling=AffinityPolicy(max_group_size=4, max_wait=0.05),
        resolve_order_per_plan=True,
    ))
    session = engine.session()
    futures = [session.submit(MultitaskRequest(
        x=torch.as_tensor(ds.sample(1)[0], device=device), tasks=s)) for s in subsets]
    session.drain()
    first = futures[0].result()
    return {
        "requests": len(futures), "groups": session.groups_executed,
        "rounds": session.admission_rounds,
        "stats_equal_predicted": session.stats == session.predicted,
        "first_effective_order": list(first.effective_order), "first_order": list(first.order),
        "weight_bytes_loaded": session.stats.weight_bytes_loaded,
        "weight_bytes_skipped": session.stats.weight_bytes_skipped,
    }


def _res_block(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """A damped residual refinement: it vanishes once the mean |activation|
    (over the whole input, as the reference's ``jnp.mean``) passes 1."""
    return h + torch.tanh(h @ p) * torch.clamp(1.0 - torch.mean(torch.abs(h)), min=0.0)


def _linear_head(p: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return h @ p


def adaptive_program(
    device: torch.device, seed: int = 2,
) -> Tuple[MultitaskProgram, List[torch.Tensor]]:
    """The damped-residual program over :func:`audio_graph` and its
    requests (70% easy, large-norm; 30% hard), drawn from
    ``np.random.default_rng(seed)`` in the reference's order."""
    dim, rng = ADAPTIVE_DIM, np.random.default_rng(seed)
    graph = audio_graph()

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    nodes = {n: tensor(rng.normal(size=(dim, dim)) / np.sqrt(dim)) for n in graph.nodes()}
    head = tensor(rng.normal(size=(dim, 4)))
    program = MultitaskProgram(
        graph, [_res_block] * graph.depth, nodes, [_linear_head] * 5, [head] * 5,
        [BlockCost(weight_bytes=4.0 * dim * dim, flops=2.0 * dim * dim)
         for _ in range(graph.depth)],
    )
    xs = [tensor(rng.normal(size=(dim,)) * (2.0 if i % 10 < 7 else 0.2))
          for i in range(ADAPTIVE_REQUESTS)]
    return program, xs


def adaptive_segment(program: MultitaskProgram, xs: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """Early exit inside the fused suffixes: the same requests through the
    all-blocks floor and through ``AdaptivePolicy(threshold=0.9)`` with
    online calibration; modelled per-request speedup on the MSP430."""
    arms = {}
    for name, adaptive in (
        ("floor", None),
        ("adaptive", AdaptivePolicy(threshold=0.9, calibrate_online=True)),
    ):
        engine = MultitaskEngine(program, hw=MSP430, policy=EnginePolicy(adaptive=adaptive))
        session = engine.session()
        for x in xs:
            session.submit(MultitaskRequest(x=x))
        session.drain()
        arms[name] = session
    floor, ad = arms["floor"], arms["adaptive"]
    return {
        "block_rows_gated": ad.stats.block_rows_gated, "flops_gated": ad.stats.flops_gated,
        "speedup": floor.stats.seconds(MSP430) / ad.stats.seconds(MSP430),
        "stats_equal_predicted": ad.stats == ad.predicted,
        "expected_flops": ad.expected.flops_executed, "realized_flops": ad.stats.flops_executed,
    }


def lm_segment(model: ModelApi, params: Any, seed: int = 0) -> Dict[str, Any]:
    """``LMServer.generate`` on ``LM_BATCH`` prompts of ``LM_PROMPT`` tokens
    drawn from ``np.random.default_rng(seed)``, ``LM_STEPS`` greedy steps."""
    cfg = model.cfg
    prompts = np.random.default_rng(seed).integers(
        0, cfg.raw_vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    server = LMServer(model, params)
    t0 = time.perf_counter()
    device = params["embed"]["embedding"].device
    out = server.generate(torch.as_tensor(prompts, device=device), steps=LM_STEPS)
    return {"tokens": out, "seconds": time.perf_counter() - t0}


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without one)")
    args = parser.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    print("== multitask audio deployment (paper §7.1) ==")
    program = build_audio_program(dev)
    ds = MultitaskDataset(num_tasks=5, num_classes=2, seed=1)
    audio = audio_segment(program, ds)
    print(f"antler order: {[TASKS[t] for t in audio['order']]}")
    print(f"requests: {N_REQUESTS} | tasks run {audio['tasks_run']}, "
          f"gated off {audio['tasks_gated_off']}")
    print(f"antler  : {audio['antler_ms']:8.2f} ms total, {audio['antler_mj']:8.2f} mJ")
    print(f"vanilla : {audio['vanilla_ms']:8.2f} ms total, {audio['vanilla_mj']:8.2f} mJ")
    print(f"reduction: {audio['reduction']:.2f}x time, "
          f"{100 * audio['energy_saving']:.0f}% energy")

    print()
    print("== session-based serving (async admission, affinity policy) ==")
    session = session_segment(program, ds)
    print(f"served {session['requests']} requests in {session['groups']} "
          f"groups over {session['rounds']} admission rounds")
    print(f"executed == predicted counters: {session['stats_equal_predicted']}")
    print(f"first request ran order {tuple(session['first_effective_order'])} "
          f"(global order {tuple(session['first_order'])})")
    print(f"weight bytes loaded {session['weight_bytes_loaded']:.0f}, "
          f"skipped via residency/prefix {session['weight_bytes_skipped']:.0f}")

    print()
    print("== input-adaptive serving (confidence gating, expected cost) ==")
    adapt = adaptive_segment(*adaptive_program(dev))
    print(f"gated off {adapt['block_rows_gated']:.0f} block-rows "
          f"({adapt['flops_gated']:.0f} flops never paid)")
    print(f"modelled per-request speedup vs all-blocks floor: {adapt['speedup']:.2f}x")
    print(f"executed == predicted counters (trace-replayed): {adapt['stats_equal_predicted']}")
    print(f"a-priori expected flops {adapt['expected_flops']:.0f} vs realized "
          f"{adapt['realized_flops']:.0f} (calibrating online toward the realized mean)")

    print()
    print("== LM serving path (prefill + KV-cached decode) ==")
    model = get_model(get_smoke_config(LM_ARCH))
    params = model.init(torch.Generator(device=dev).manual_seed(1), dev)
    lm = lm_segment(model, params)
    print(f"generated {lm['tokens'].shape} tokens in {lm['seconds']:.1f}s "
          f"(batch {LM_BATCH}, greedy, reduced granite config)")
    print("sample:", lm["tokens"][0][:10])
    return {"device": str(dev), "audio": audio, "session": session, "adaptive": adapt,
            "lm": lm}


if __name__ == "__main__":
    main()
