"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (the Pearson Gram, flash attention and the
   Mamba2 SSD scan) from the sources in this checkout, one ``nvcc`` each,
   started together, and prints each build time and what ``ptxas -v`` said
   of each kernel (registers, shared memory, spills).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at ragged ones (fp32 and bf16, GQA, a sliding
   window, head_dim 80; the SSD at both model shapes, a ragged length in
   bf16 at mamba2's widths and in fp32, and the reference sweep's shapes),
   checks that two Pearson calls and two bf16 SSD calls give the same bits,
   and times kernel, plain version and, where one exists, one library call
   (the yardstick only) with CUDA events; a bf16 SSD row also gives each of
   its three kernels' device time from one profiler window, the bytes each
   must move and its scratch bytes.
3. Drives Antler's main path on the paper's LeNet-5 at full width: affinity
   profiling of 5 random-initialised per-task networks on 512 probes,
   task-graph selection, Held-Karp and GA ordering, then
   ``MultitaskEngine.serve_batch`` on 48 requests over several task subsets.
   The same engine then serves the same requests through
   ``engine.session`` under each of the four admission policies (greedy,
   window, affinity, SLO-aware), arriving in bursts on a simulated clock,
   and once more under scripted faults at the "plan", "load" and "dispatch"
   sites (a group retried, a group served by the unfused rung).  Then the
   quickstart (``repro_torch.examples.quickstart``) runs its five steps at
   its reference sizes: 200 SGD steps, the profile, selection, ordering and
   Antler against Vanilla; then the block profiler on the card.
4. Drives the same path on a transformer backbone: mistral-nemo-12b at full
   width (d_model 5120, GQA 32/8, head_dim 160, bf16), its 40 layers cut to
   8, sequences of 128 tokens, 256 random-token probes, 4 blocks of 2 layers;
   then the same sessions as the LeNet engine's.
5. Drives ``LMServer.generate`` on the same configuration: 4 prompts of 512
   tokens, 16 greedy decode steps.
6. Drives ``LMServer.generate`` on mamba2-780m at full width and depth (48
   layers, bf16): 4 prompts of 2048 tokens, 32 greedy steps; then on
   zamba2-2.7b at full width and depth (54 layers, bf16): 4 prompts of 1024
   tokens, 16 steps.
7. Runs the serve launcher (``repro_torch.launch.serve``) in-process on
   mamba2-780m for a few steps; it prints its tokens/s line.
8. Prints one ``{"kernels": [...]}`` line, then the device line last.

Each path runs with every launch count set to 0 just before it and read
just after; the script checks that the kernels ran where the path runs
them (Pearson 15 times per profile, the quickstart's included; flash
attention 30 times in the transformer profile, twice per executed block in
serving and in every session, 8 times in the prefill, 9 times in zamba2's;
the SSD once per Mamba2 layer of a prefill, 48 and 54, and never in
decode), that served counters equal the cost model's prediction field for
field (every session's too, faults included), that served outputs match
the per-block executor, that every session request succeeds, that faulted
outputs match the fault-free session's, that the quickstart's loss falls,
that Antler beats Vanilla, and that the first decode step agrees with
``forward``.  Any failed check raises.  Each session prints a JSON line:
admission rounds, groups, planning seconds, its wall seconds to the end of
the drain, admission waits (simulated seconds), weight bytes loaded, the
device's busy share over the session, and how many rounds were planned
while the card still had queued work.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  TF32 is switched off for matmuls and cuDNN:
the checks hold fp32 to 1e-5, 2e-5 and 2e-4.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MSP430, TPU_V5E, GAConfig, GraphCostModel, TaskGraph, TaskGraphExecutor,
    VanillaExecutor, genetic_order, optimal_order,
)
from repro_torch.core.affinity import affinity_matrix, profile_task  # noqa: E402
from repro_torch.core.tradeoff import select_task_graph  # noqa: E402
from repro_torch.data import MultitaskDataset, train_test_split  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples.quickstart import branch_point_taps  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    SOURCE as FLASH_SOURCE, flash_attention,
)
from repro_torch.kernels.pearson_affinity import (  # noqa: E402
    SOURCE as PEARSON_SOURCE, pearson_dissimilarity,
)
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_bhsd_ref, flash_attention_ref, pearson_dissimilarity_ref, ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SOURCE as SSD_SOURCE, kernel_bytes as ssd_kernel_bytes, scratch_bytes as ssd_scratch_bytes,
    ssd_scan,
)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models.cnn import build_lenet5_blocks  # noqa: E402
from repro_torch.models.multitask import (  # noqa: E402
    _split_layers, build_cnn_program, build_transformer_program,
    transformer_block_costs,
)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.core.profiler import profile_program_blocks  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AffinityPolicy, FaultInjector, GreedyBatchPolicy, LMServer, MultitaskEngine,
    MultitaskRequest, RetryPolicy, SloAwarePolicy, WindowPolicy,
)
from repro_torch.serving.engine import _grow_cache  # noqa: E402

N_TASKS, N_CLASSES, N_BRANCH_POINTS = 5, 4, 3
N_PROBES = 512
N_REQUESTS = 48
SUBSETS = (None, (0, 1), (2, 3, 4), (1, 3), (4,))
# (K, F): the LeNet path's three branch points at K = 512, the transformer
# profile's taps (K = 256 probes, F = 128 tokens x d_model 5120), then
# ragged edges.
PEARSON_SHAPES = ((512, 1568), (512, 784), (512, 64), (256, 128 * 5120), (37, 100), (64, 300))
FP32_TOL, BF16_TOL, PIPELINE_TOL = 1e-5, 5e-2, 1e-5
# Flash attention: the reference sweep's tolerances (tests/test_kernels.py).
FLASH_FP32_TOL, FLASH_BF16_TOL = 2e-5, 2e-2
# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores,
# dense bf16 on the tensor cores, HBM3.
FP32_PEAK_FLOPS, BF16_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12

# The transformer paths: mistral-nemo-12b at full width, depth 40 -> 8.
ARCH, TF_LAYERS, TF_SEQ, TF_PROBES = "mistral-nemo-12b", 8, 128, 256
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 512, 16
TF_TOL = 5e-2  # bf16 activations: served vs per-block, decode vs forward
# Flash shapes of the main paths, model layout (B, S, Hq, Hk, d), bf16 causal:
# a serving group of 16, the LM prefill, the profile's probe batch.
FLASH_MAIN = (("serve_group", 16, 128, 32, 8, 160), ("lm_prefill", 4, 512, 32, 8, 160),
              ("profile", 256, 128, 32, 8, 160), ("zamba2_prefill", 4, 1024, 32, 32, 80))
# Ragged and windowed checks: (layout, B, S, T, Hq, Hk, d, causal, window).
FLASH_RAGGED = (
    ("flat", 4, 70, 70, 1, 1, 32, True, None),
    ("flat", 4, 48, 96, 1, 1, 64, True, None),
    ("flat", 2, 33, 33, 6, 1, 16, True, None),
    ("flat", 4, 70, 70, 1, 1, 32, True, 24),
    ("flat", 4, 70, 70, 1, 1, 32, False, 24),
    ("bhsd", 2, 300, 300, 4, 2, 64, True, 24),
    ("bhsd", 1, 200, 200, 4, 1, 128, False, 40),
    ("bhsd", 2, 150, 150, 32, 8, 160, True, 24),
    ("bhsd", 4, 1024, 1024, 32, 32, 80, True, None),  # zamba2's prefill, fp32 too
)

# The SSM paths at full width and depth: (arch, batch, prompt, steps).
MAMBA2 = ("mamba2-780m", 4, 2048, 32)
ZAMBA2 = ("zamba2-2.7b", 4, 1024, 16)
SSM_CHECK_BATCH = 2  # rows of the decode-vs-forward check
LAUNCHER_STEPS = 4
# SSD scan shapes (path, B, S, H, P, N, chunk, dtype): the two model
# prefills (x, B and C views of one conv output, as in the model), a ragged
# length at mamba2's widths (bf16) and at four heads (fp32), the reference
# sweep's shapes (tests/test_kernels.py).
SSD_SHAPES = (
    ("mamba2_prefill", 4, 2048, 48, 64, 128, 64, torch.bfloat16),
    ("zamba2_prefill", 4, 1024, 80, 64, 64, 256, torch.bfloat16),
    ("ragged_bf16", 2, 200, 48, 64, 128, 64, torch.bfloat16),
    ("ragged", 2, 200, 4, 64, 128, 64, torch.float32),
    ("sweep", 2, 24, 2, 4, 8, 8, torch.float32),
    ("sweep", 2, 50, 3, 8, 4, 16, torch.float32),
    ("sweep", 2, 64, 4, 16, 16, 32, torch.float32),
)
SSD_FP32_TOL, SSD_BF16_TOL = 2e-4, 5e-2  # abs and rel: the reference sweep's


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls made back to back
    between two CUDA events, after ``warmup`` calls: the host queues the
    next launch while the card runs this one, so a call's host time shows
    only where it exceeds its device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Host milliseconds per call of ``fn`` over ``reps`` calls made back to
    back, without waiting for the card: where this exceeds the device time,
    ``cuda_ms`` measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Laps:
    """Host-clock seconds between successive synchronised points."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = {}
        sync(device)
        self._last = time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now


def pearson_bound(k: int, f: int) -> dict:
    """Least time on the card: K*(K+1)*F fp32 FLOPs (the upper triangle of
    the symmetric Z Z^T, diagonal included) vs K*F + K*K fp32 bytes.  Also
    the bound of the full product, 2*K*K*F FLOPs, which earlier runs used."""
    ops_ms = 1.0 * k * (k + 1) * f / FP32_PEAK_FLOPS * 1e3
    bytes_ms = 4.0 * (k * f + k * k) / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_ms_full_product": max(2.0 * k * k * f / FP32_PEAK_FLOPS * 1e3, bytes_ms),
    }


def launch_counts() -> dict:
    return {"pearson_gram": pearson_dissimilarity.launches,
            "flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches}


def reset_launch_counts() -> None:
    pearson_dissimilarity.launches = 0
    flash_attention.launches = 0
    ssd_scan.launches = 0


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peak_gb(device: torch.device) -> float:
    """Peak device memory since the last reset, in GB (0 on the CPU)."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e9


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def build_kernels() -> dict:
    """One nvcc per source, all started together; seconds each."""
    def timed(source: str) -> float:
        t0 = time.perf_counter()
        _build.build(source)
        return time.perf_counter() - t0

    sources = (PEARSON_SOURCE, FLASH_SOURCE, SSD_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {src: pool.submit(timed, src) for src in sources}
        return {src: f.result() for src, f in futures.items()}


def kernel_phase(device: torch.device) -> dict:
    """Pearson kernel vs its plain version at every listed shape."""
    rng = np.random.default_rng(0)
    rows = []
    for k, f in PEARSON_SHAPES:
        feats = torch.as_tensor(
            rng.standard_normal((k, f)).astype(np.float32), device=device
        )
        z = ops.standardize_rows(feats).contiguous()
        out = pearson_dissimilarity(z)
        again = pearson_dissimilarity(z)
        plain = pearson_dissimilarity_ref(z)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        check(err <= FP32_TOL, f"pearson fp32 {k}x{f}: max abs err {err} > {FP32_TOL}")
        check(torch.equal(out, out.T), f"pearson fp32 {k}x{f}: output not symmetric")
        check(torch.equal(out, again), f"pearson fp32 {k}x{f}: two calls differ")

        fb = feats.to(torch.bfloat16)
        out_bf = ops.pairwise_pearson_dissimilarity(fb)
        plain_bf = pearson_dissimilarity_ref(ops.standardize_rows(fb))
        torch.cuda.synchronize()
        err_bf = float((out_bf - plain_bf).abs().max())
        check(err_bf <= BF16_TOL, f"pearson bf16 {k}x{f}: max abs err {err_bf} > {BF16_TOL}")

        one = torch.ones((), device=device)
        row = {
            "kernel": "pearson_gram", "K": k, "F": f,
            "max_abs_err": err, "max_abs_err_bf16": err_bf, "bit_identical": True,
            "kernel_ms": cuda_ms(lambda: pearson_dissimilarity(z)),
            "kernel_host_ms": host_ms(lambda: pearson_dissimilarity(z)),
            "plain_ms": cuda_ms(lambda: pearson_dissimilarity_ref(z)),
            # One library call computing 1 - Z Z^T: the yardstick only.
            "library_ms": cuda_ms(lambda: torch.addmm(one, z, z.T, alpha=-1.0)),
            "library_host_ms": host_ms(lambda: torch.addmm(one, z, z.T, alpha=-1.0)),
            **pearson_bound(k, f),
            "peak": "fp32 CUDA cores 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {
        "rows": rows,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
    }


def check_affinity(aff: np.ndarray) -> None:
    check(aff.shape == (N_BRANCH_POINTS, N_TASKS, N_TASKS), f"affinity shape {aff.shape}")
    check(bool(np.isfinite(aff).all()), "affinity has non-finite entries")
    check(np.allclose(np.diagonal(aff, axis1=1, axis2=2), 1.0, atol=1e-5),
          "affinity diagonal is not 1")


def select_and_order(aff: np.ndarray, costs, hw, laps: Laps, label: str):
    """Task-graph selection, then the exact and the GA order on ``hw``."""
    sel = select_task_graph(N_TASKS, N_BRANCH_POINTS, aff, costs, hw).selected
    laps.lap("select")
    cm = GraphCostModel(sel.graph, costs, hw)
    exact = optimal_order(cm.cost_matrix())
    ga = genetic_order(cm.cost_matrix(), config=GAConfig(seed=0))
    laps.lap("order")
    check(ga.cost >= exact.cost - 1e-12, "GA beat the exact solver")
    print(f"{label}selected graph {sel.graph.partitions}; exact order {exact.order} "
          f"cost {exact.cost * 1e3:.3f} ms (modelled, {hw.name}); GA order "
          f"{ga.order} cost {ga.cost * 1e3:.3f} ms", flush=True)
    return sel, exact


def check_group_outputs(engine, groups, responses_of, device, tol: float, label: str) -> float:
    """Every served output matches the per-block executor on its group;
    ``responses_of(group)`` gives the group's responses in slot order.
    Returns the max abs error."""
    reference = TaskGraphExecutor(engine.program, fused=False)
    max_err = 0.0
    for group in groups:
        outs, _stats = reference.run_batch(
            group.xs.to(device), engine.group_order(group), valid=group.valid
        )
        for slot, response in enumerate(responses_of(group)):
            got = response.outputs
            check(set(got) == set(engine.group_order(group)), f"{label}slot {slot} tasks")
            for t, y in got.items():
                check(tuple(y.shape) == (1, N_CLASSES), f"output shape {tuple(y.shape)}")
                check(bool(torch.isfinite(y).all()), "non-finite output")
                max_err = max(max_err, float((y - outs[t][slot]).abs().max()))
    check(max_err <= tol, f"{label}served vs per-block max abs err {max_err}")
    return max_err


def check_served(engine, plan, requests, responses, predicted, device, tol: float,
                 label: str) -> float:
    """Served counters equal the prediction field for field, and every served
    output matches the per-block executor on its group; the max abs error."""
    check(engine.last_batch_stats == predicted,
          f"{label}served counters {engine.last_batch_stats} != predicted {predicted}")
    check(len({engine.normalized_subset(r.tasks) for r in requests}) >= 4,
          "fewer than 4 task subsets requested")
    return check_group_outputs(
        engine, plan, lambda g: [responses[i] for i in g.indices], device, tol, label)


def check_beats_vanilla(program, x: torch.Tensor, order, hw, label: str) -> None:
    """Antler's block cache against the Vanilla baseline (quickstart step 5):
    fewer blocks executed and less modelled time on ``hw``."""
    _o, s_ant = TaskGraphExecutor(program).run(x, list(order))
    _o, s_van = VanillaExecutor(program).run(x, list(order))
    for name, st in (("antler ", s_ant), ("vanilla", s_van)):
        print(f"{label}{name}: {st.blocks_executed} blocks executed, {st.blocks_skipped} "
              f"skipped, {st.seconds(hw) * 1e3:.2f} ms modelled ({hw.name})", flush=True)
    check(s_van.seconds(hw) > s_ant.seconds(hw), "Vanilla not slower than Antler")
    check(s_van.blocks_executed > s_ant.blocks_executed, "Vanilla executed no more blocks")


def pipeline_phase(device: torch.device, n_probes: int = N_PROBES) -> dict:
    """Quickstart steps 1 and 3-5 on ``device`` (no training)."""
    ds = MultitaskDataset(num_tasks=N_TASKS, num_classes=N_CLASSES, seed=0)
    (_xtr, _ytr), (xte, _yte) = train_test_split(ds, 2048, n_probes)
    _i, _a, costs, _f = build_lenet5_blocks()
    laps = Laps(device)

    # Affinity: profile each per-task network of the fully-separate graph.
    sep = TaskGraph.fully_separate(N_TASKS, N_BRANCH_POINTS)
    prog = build_cnn_program(
        sep, [N_CLASSES] * N_TASKS,
        generator=torch.Generator().manual_seed(0), device=device,
    )
    probe = torch.as_tensor(xte, device=device)
    laps.lap("build_program")
    profiles = [
        profile_task(branch_point_taps(prog, t, probe)) for t in range(N_TASKS)
    ]
    laps.lap("profile")
    aff = affinity_matrix(profiles).cpu().numpy()
    laps.lap("spearman")
    check_affinity(aff)

    # Task-graph selection and ordering.
    sel, exact = select_and_order(aff, costs, MSP430, laps, "")

    # Serving: request groups through the block-cached engine.
    prog2 = build_cnn_program(
        sel.graph, [N_CLASSES] * N_TASKS,
        generator=torch.Generator().manual_seed(1), device=device,
    )
    engine = MultitaskEngine(prog2, hw=MSP430)
    rng = np.random.default_rng(1)
    picks = rng.integers(0, len(SUBSETS), size=N_REQUESTS)
    rows = rng.integers(0, xte.shape[0], size=N_REQUESTS)
    requests = [
        MultitaskRequest(x=xte[r:r + 1], tasks=SUBSETS[s])
        for r, s in zip(rows, picks)
    ]
    laps.lap("build_engine")
    plan = engine.plan_groups(requests)
    predicted = engine.predicted_group_stats(plan)
    laps.lap("plan")
    responses = engine.serve_batch(requests)
    laps.lap("serve")
    max_err = check_served(engine, plan, requests, responses, predicted, device,
                           PIPELINE_TOL, "")
    check_beats_vanilla(prog2, torch.as_tensor(xte[:8], device=device), exact.order,
                        MSP430, "")
    return {
        "engine": engine, "plan": plan, "requests": requests,
        "laps": laps.seconds, "max_err": max_err,
    }


def time_groups(result: dict, reps: int = 20, warmup: int = 2) -> list:
    """Per-group wall time of the engine's group execution (CUDA events),
    after the checked run, on a warm engine."""
    engine = result["engine"]
    out = []
    for group in result["plan"]:
        ms = cuda_ms(lambda: engine._execute_group(group), reps=reps, warmup=warmup)
        out.append({"tasks": sorted(group.tasks) if group.tasks else "all",
                    "valid": group.valid, "padded": int(group.xs.shape[0]),
                    "order": list(engine.group_order(group)), "ms": ms})
    return out


# --------------------------------------------------------------------------
# Sessions: the four admission policies and scripted faults
# --------------------------------------------------------------------------

# The phase's requests arrive in bursts on a simulated clock: BURST requests
# every BURST_DT seconds, one ``step`` after each burst, a ``drain`` at the
# end.  Every fourth request carries a deadline DEADLINE_IN after its
# arrival, far enough that none expires; the SLO policy counts it urgent
# once its slack is below SLACK.
BURST, BURST_DT, DEADLINE_IN, SLACK = 8, 0.1, 10.0, 9.8
SESSION_POLICIES = {
    "greedy": GreedyBatchPolicy(),
    "window": WindowPolicy(max_wait=0.15, max_group_size=16),
    "affinity": AffinityPolicy(max_group_size=16, min_pending=12, max_wait=0.3),
    "slo": SloAwarePolicy(max_group_size=16, min_pending=12, max_wait=0.3,
                          slack_threshold=SLACK, starvation_wait=0.25),
}
# Scripted faults for the chaos session (invocation indices per site, with
# RetryPolicy()'s two retries): three "plan" faults in a row send one group
# to the unfused rung; the lone "load" and "dispatch" faults are retried.
CHAOS_SCRIPT = {"plan": {1, 2, 3}, "load": {6}, "dispatch": {12}}


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def serve_session(engine, requests, policy, fault_injector=None):
    """One session over ``requests`` from a cold executor, on a simulated
    clock, with no backoff sleeps.  Returns the session, the responses (in
    request order), each response keyed by the id of its submitted request,
    the groups the admission rounds planned, the seconds from the first
    submit to the drain's end (device synchronised), and for each round
    after the first whether the card still had queued work when its planning
    began (planning overlapping execution)."""
    engine.executor.reset()
    engine.fault_injector = fault_injector
    groups, busy_at_plan = [], []
    plan = engine.plan_groups
    cuda = engine.device.type == "cuda"

    def recorded(reqs):
        if cuda and groups:
            busy_at_plan.append(not torch.cuda.current_stream(engine.device).query())
        out = plan(reqs)
        groups.extend(out)
        return out

    engine.plan_groups = recorded
    clock = SimClock()
    session = engine.session(policy=policy, clock=clock, sleep=lambda _s: None,
                             retry=RetryPolicy())
    try:
        sync(engine.device)
        t0 = time.perf_counter()
        futures, submitted = [], []
        for i, r in enumerate(requests):
            if i and i % BURST == 0:
                session.step()
                clock.t += BURST_DT
            submitted.append(MultitaskRequest(
                x=r.x, tasks=r.tasks, tenant=("a", "b", "c")[i % 3],
                deadline=clock.t + DEADLINE_IN if i % 4 == 0 else None))
            futures.append(session.submit(submitted[-1]))
        session.step()
        clock.t += BURST_DT
        session.drain()
        sync(engine.device)
        seconds = time.perf_counter() - t0
    finally:
        del engine.plan_groups
        engine.fault_injector = None
    check(all(f.done() for f in futures), "a session future is not terminal")
    for f in futures:
        check(f.error() is None, f"session request {f.seq} failed: {f.error()!r}")
    responses = [f.result() for f in futures]
    by_request = {id(r): resp for r, resp in zip(submitted, responses)}
    return session, responses, by_request, groups, seconds, busy_at_plan


def check_session(engine, session, by_request, groups, device, tol, label) -> float:
    """Counters equal the prediction field for field; outputs equal the
    per-block executor's on each planned group."""
    check(session.stats == session.predicted,
          f"{label}session counters {session.stats} != predicted {session.predicted}")
    return check_group_outputs(
        engine, groups, lambda g: [by_request[id(r)] for r in g.requests], device, tol,
        label)


def session_phase(engine, requests, device, tol: float, label: str,
                  layers_per_block=None) -> dict:
    """The phase's requests through ``engine.session`` under each policy;
    launch counts are set to 0 just before each session and read just after.
    Prints one JSON line per policy."""
    out = {}
    for name, policy in SESSION_POLICIES.items():
        reset_launch_counts()
        session, responses, by_request, groups, seconds, busy_at_plan = serve_session(
            engine, requests, policy)
        launches = launch_counts()
        err = check_session(engine, session, by_request, groups, device, tol,
                            f"{label}{name} ")
        if layers_per_block is not None and device.type == "cuda":
            check(launches["flash_attention"] == layers_per_block * session.stats.blocks_executed,
                  f"{label}{name}: flash launched {launches['flash_attention']} times, "
                  f"expected {layers_per_block} x {session.stats.blocks_executed} blocks")
        row = {
            "engine": label.strip(), "policy": name,
            "requests": len(responses), "admission_rounds": session.admission_rounds,
            "groups": session.groups_executed, "plan_seconds": session.plan_seconds,
            "drain_seconds": seconds,
            "mean_admission_wait_sim_s": session.mean_admission_wait,
            "max_admission_wait_sim_s": session.max_admission_wait,
            "weight_bytes_loaded": session.stats.weight_bytes_loaded,
            "blocks_executed": session.stats.blocks_executed,
            "launches": launches, "max_abs_err": err,
            "rounds_planned_while_card_busy": sum(busy_at_plan),
            "rounds_after_first": len(busy_at_plan),
        }
        if device.type == "cuda":
            # The checked run above was the warm-up.
            trace = device_breakdown(lambda: serve_session(engine, requests, policy),
                                     seconds * 1e3, warm=False, cpu=False)
            check(trace["device_ms"] > 0, f"{label}{name}: the profiler saw no device time")
            row.update(busy=trace["busy"], device_ms=trace["device_ms"],
                       kernels=trace["kernels"], profiled_window_ms=trace["window_ms"])
        print(json.dumps({"session": row}), flush=True)
        out[name] = {"row": row, "responses": responses}
    ratio = (out["affinity"]["row"]["weight_bytes_loaded"]
             / out["window"]["row"]["weight_bytes_loaded"])
    print(json.dumps({"session_weight_bytes_ratio": {
        "engine": label.strip(), "affinity_over_window": ratio}}), flush=True)
    return out


def chaos_phase(engine, requests, clean_responses, device, tol: float, label: str,
                policy_name: str = "window") -> dict:
    """One session under ``CHAOS_SCRIPT``: at least one group retried on the
    primary path and one served by the unfused rung, the injector's counts
    as scripted, counters equal to the prediction, outputs allclose to the
    fault-free session's under the same policy."""
    injector = FaultInjector(script=CHAOS_SCRIPT)
    reset_launch_counts()
    session, responses, by_request, groups, seconds, _busy = serve_session(
        engine, requests, SESSION_POLICIES[policy_name], injector)
    launches = launch_counts()
    check_session(engine, session, by_request, groups, device, tol, f"{label}chaos ")
    check(engine.executor.fused, f"{label}chaos: the unfused rung left fused dispatch off")
    expected = {site: len(idx) for site, idx in CHAOS_SCRIPT.items()}
    got = {site: injector.injected[site] for site in CHAOS_SCRIPT}
    check(got == expected, f"{label}chaos: injected {got}, scripted {expected}")
    retried = sum(r.retries > 0 and r.degraded is None for r in responses)
    degraded = sum(r.degraded == "unfused" for r in responses)
    check(retried >= 1, f"{label}chaos: no response was retried on the primary path")
    check(degraded >= 1, f"{label}chaos: no response was served by the unfused rung")
    check(session.degraded_runs >= 1 and session.group_retries >= 3,
          f"{label}chaos: {session.degraded_runs} degraded runs, "
          f"{session.group_retries} retries")
    max_err = 0.0
    for got_r, clean_r in zip(responses, clean_responses):
        check(set(got_r.outputs) == set(clean_r.outputs), f"{label}chaos: tasks differ")
        for t, y in got_r.outputs.items():
            max_err = max(max_err, float((y - clean_r.outputs[t]).abs().max()))
    check(max_err <= tol, f"{label}chaos vs fault-free max abs err {max_err}")
    row = {"engine": label.strip(), "policy": policy_name,
           "injected": got, "invocations": dict(injector.invocations),
           "responses_retried": retried, "responses_unfused": degraded,
           "group_retries": session.group_retries, "degraded_runs": session.degraded_runs,
           "groups": session.groups_executed, "drain_seconds": seconds,
           "launches": launches, "max_abs_err_vs_fault_free": max_err}
    print(json.dumps({"session_chaos": row}), flush=True)
    return row


# --------------------------------------------------------------------------
# The quickstart
# --------------------------------------------------------------------------

def quickstart_phase(device: torch.device) -> dict:
    """``repro_torch.examples.quickstart`` on ``device`` at its reference
    sizes; launch counts set to 0 just before and read just after.  Then the
    block profiler on the card."""
    reset_launch_counts()
    t0 = time.perf_counter()
    out = quickstart.main([], device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    losses, aff = out["losses"], out["aff"]
    check(losses[-1] < losses[0], f"quickstart: joint loss did not fall ({losses[0]} -> "
          f"{losses[-1]})")
    expected = N_TASKS * N_BRANCH_POINTS if device.type == "cuda" else 0
    check(launches["pearson_gram"] == expected,
          f"quickstart: pearson launched {launches['pearson_gram']} times, expected {expected}")
    check(bool(np.isfinite(aff).all()), "quickstart: non-finite affinity")
    check(np.allclose(aff, aff.transpose(0, 2, 1), atol=1e-6), "quickstart: affinity asymmetric")
    check(out["ga"].cost >= out["exact"].cost - 1e-12, "quickstart: GA beat the exact solver")
    hw = quickstart.get_hardware(quickstart.HARDWARE)
    check(out["vanilla"].seconds(hw) > out["antler"].seconds(hw),
          "quickstart: Vanilla not slower than Antler")
    check(out["vanilla_report"].seconds > out["antler_report"].seconds,
          "quickstart: modelled Vanilla not slower than Antler")

    # The block profiler on the trained program's architecture.
    prog = build_cnn_program(TaskGraph.fully_shared(N_TASKS, N_BRANCH_POINTS),
                             [N_CLASSES] * N_TASKS,
                             generator=torch.Generator().manual_seed(0), device=device)
    probe = torch.as_tensor(np.zeros((64, 28, 28, 1), np.float32), device=device)
    profiled = profile_program_blocks(prog, probe, MSP430)
    _i, _a, table, _f = build_lenet5_blocks()
    for p, t in zip(profiled, table):
        check((p.weight_bytes, p.act_bytes) == (t.weight_bytes, t.act_bytes),
              f"profiled bytes {p} != the LeNet-5 table's {t}")
        check(bool(np.isfinite(p.flops)) and p.flops > 0, f"profiled flops {p.flops}")
    row = {"seconds": seconds, "first_loss": losses[0], "final_loss": losses[-1],
           "launches": launches, "selected": out["selection"].selected.graph.partitions,
           "exact_order": list(out["exact"].order), "ga_order": list(out["ga"].order),
           "exact_cost": out["exact"].cost, "ga_cost": out["ga"].cost,
           "antler_blocks": out["antler"].blocks_executed,
           "vanilla_blocks": out["vanilla"].blocks_executed,
           "profiled_block_ms_per_sample": [p.flops / MSP430.peak_flops * 1e3 for p in profiled]}
    print(json.dumps({"quickstart": row}), flush=True)
    return row


# Device kernel names of the port's kernels (both passes of the Pearson Gram).
PORT_KERNELS = ("pearson_partial_kernel", "pearson_reduce_kernel", "flash_bf16_kernel",
                "flash_fp32_kernel", "ssd_scan_kernel", "ssd_chunk_state_kernel",
                "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
# The bf16 SSD's three kernels, in launch order.
SSD_BF16_KERNELS = PORT_KERNELS[-3:]


def device_breakdown(fn, timed_ms: float, top: int = 6, warm: bool = True,
                     cpu: bool = True) -> dict:
    """``torch.profiler`` over one call of ``fn`` (after a warm-up call unless
    ``warm`` is off): device time by kernel name (the top ones, and the
    port's own kernels), the device total, and the host window around the
    call with the profiler on (which slows the host).  ``busy`` is the
    device total over ``timed_ms``, the call's time without the profiler:
    the device's busy share, an upper bound where kernels overlap.  ``cpu``
    off traces the device alone, which keeps the trace of a call with tens
    of thousands of kernels cheap to read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    device_ms = sum(us for _c, us in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    port = {}
    for name, (c, us) in by_name.items():
        kernel = next((k for k in PORT_KERNELS if k in name), None)
        if kernel:
            calls, ms = port.get(kernel, (0, 0.0))
            port[kernel] = (calls + c, ms + us / 1e3)
    return {
        "window_ms": window_ms, "timed_ms": timed_ms, "device_ms": device_ms,
        "busy": device_ms / timed_ms,
        "kernels": sum(c for c, _us in by_name.values()),
        "top": [{"name": name[:80], "calls": c, "ms": us / 1e3}
                for name, (c, us) in ranked[:top]],
        "port_kernels": {k: {"calls": c, "ms": ms} for k, (c, ms) in port.items()},
    }


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

def allowed_pairs(s: int, t: int, causal: bool, window) -> int:
    """Query-key pairs the mask keeps (positions are indices)."""
    qp = torch.arange(s)[:, None]
    kp = torch.arange(t)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    return int(mask.sum())


def flash_bound(q: torch.Tensor, k: torch.Tensor, causal: bool, window) -> dict:
    """Least time on the card for model-layout ``q`` (B, S, Hq, d) over
    ``k``/``v`` (B, T, Hk, d): 4 * B * Hq * pairs * d operations at the peak
    of the input type vs q, k, v and o moved once (K/V not repeated)."""
    b, s, hq, d = q.shape
    peak = BF16_PEAK_FLOPS if q.dtype == torch.bfloat16 else FP32_PEAK_FLOPS
    ops_ms = 4.0 * b * hq * allowed_pairs(s, k.shape[1], causal, window) * d / peak * 1e3
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


def _randn(rng, shape, dtype, device):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device).to(dtype)


def flash_phase(device: torch.device) -> dict:
    """Flash kernel vs its plain version at the main paths' shapes (timed,
    with SDPA as the yardstick) and at ragged / windowed ones."""
    rng = np.random.default_rng(1)
    rows, max_err = [], 0.0
    for name, b, s, hq, hk, d in FLASH_MAIN:
        q = _randn(rng, (b, s, hq, d), torch.bfloat16, device)
        k = _randn(rng, (b, s, hk, d), torch.bfloat16, device)
        v = _randn(rng, (b, s, hk, d), torch.bfloat16, device)
        out = ops.flash_attention_bhsd(q, k, v)
        plain = flash_attention_bhsd_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        check(err <= FLASH_BF16_TOL, f"flash bf16 {name}: max abs err {err} > {FLASH_BF16_TOL}")
        max_err = max(max_err, err)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = {
            "kernel": "flash_attention", "path": name, "shape": [b * hq, s, d],
            "B": b, "S": s, "Hq": hq, "Hk": hk, "d": d, "dtype": "bfloat16",
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: ops.flash_attention_bhsd(q, k, v), reps=20),
            "kernel_host_ms": host_ms(lambda: ops.flash_attention_bhsd(q, k, v), reps=20),
            "plain_ms": cuda_ms(lambda: flash_attention_bhsd_ref(q, k, v), reps=10),
            # One library call computing the same attention: the yardstick only.
            "library_ms": cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                  reps=20),
            "library_host_ms": host_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                                    enable_gqa=True), reps=20),
            **flash_bound(q, k, True, None),
            "peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, plain
        free_memory()

    for layout, b, s, t, hq, hk, d, causal, window in FLASH_RAGGED:
        for dtype, tol in ((torch.float32, FLASH_FP32_TOL), (torch.bfloat16, FLASH_BF16_TOL)):
            if layout == "flat":
                q = _randn(rng, (b * hq, s, d), dtype, device)
                k = _randn(rng, (b * hk, t, d), dtype, device)
                v = _randn(rng, (b * hk, t, d), dtype, device)
                out = flash_attention(q, k, v, causal=causal, window=window)
                plain = flash_attention_ref(q, k, v, causal=causal, window=window)
            else:
                q = _randn(rng, (b, s, hq, d), dtype, device)
                k = _randn(rng, (b, t, hk, d), dtype, device)
                v = _randn(rng, (b, t, hk, d), dtype, device)
                out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
                plain = flash_attention_bhsd_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == plain.shape, "flash output dtype/shape")
            err = float((out.float() - plain.float()).abs().max())
            what = f"flash {layout} {b}x{s}x{t} heads {hq}/{hk} d {d} causal {causal} " \
                   f"window {window} {dtype}"
            check(err <= tol, f"{what}: max abs err {err} > {tol}")
            max_err = max(max_err, err)
            print(json.dumps({"kernel": "flash_attention", "check": what, "max_abs_err": err}),
                  flush=True)
    return {"rows": rows, "max_abs_err": max_err}


# --------------------------------------------------------------------------
# The SSD scan
# --------------------------------------------------------------------------

def ssd_bound(b: int, s: int, h: int, p: int, n: int, q: int, dtype: torch.dtype) -> dict:
    """Least time on the card for one chunked SSD: B nc [2 Qc N + H (2 Qc P
    + 4 Q N P)] operations (causal pairs only, Qc = Q (Q + 1) / 2) at the
    peak of the input type, against x, dt, a, B, C read once and y and the
    final state (fp32) written once."""
    nc, qc = -(-s // q), q * (q + 1) // 2
    ops_count = b * nc * (2 * qc * n + h * (2 * qc * p + 4 * q * n * p))
    peak = BF16_PEAK_FLOPS if dtype == torch.bfloat16 else FP32_PEAK_FLOPS
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    ops_ms = ops_count / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations": ops_count, "bytes": nbytes}


def ssd_inputs(rng, b, s, h, p, n, dtype, device):
    """x, B and C as views of one (B, S, H P + 2 N) conv output, as the model
    makes them; dt = softplus(normal) and a = -exp(normal) in fp32, the
    reference sweep's distributions."""
    conv = _randn(rng, (b, s, h * p + 2 * n), dtype, device)
    xin, bb, cc = torch.split(conv, [h * p, n, n], dim=-1)
    dt = torch.nn.functional.softplus(_randn(rng, (b, s, h), torch.float32, device))
    a = -torch.exp(_randn(rng, (h,), torch.float32, device))
    return xin.reshape(b, s, h, p), dt, a, bb, cc


def ssd_phase(device: torch.device) -> dict:
    """SSD kernel vs its plain version at every listed shape: y and the
    final state within the tolerance (abs + rel), timed at every shape.  No
    single PyTorch call computes the SSD, so there is no library time.  A
    bf16 row also checks that two calls give the same bits, and gives the
    device time of each of the three bf16 kernels from one profiler window,
    the bytes each must move and the scratch they pass through."""
    rng = np.random.default_rng(3)
    rows, max_err = [], 0.0
    for path, b, s, h, p, n, q, dtype in SSD_SHAPES:
        x, dt, a, bb, cc = ssd_inputs(rng, b, s, h, p, n, dtype, device)
        y, fin = ops.ssd_scan(x, dt, a, bb, cc, q)
        ry, rfin = ssd_scan_ref(x, dt, a, bb, cc, q)
        torch.cuda.synchronize()
        tol = SSD_BF16_TOL if dtype == torch.bfloat16 else SSD_FP32_TOL
        what = f"ssd {path} B {b} S {s} H {h} P {p} N {n} chunk {q} {dtype}"
        check(y.dtype == dtype and y.shape == x.shape and fin.shape == rfin.shape,
              f"{what}: output dtype/shape")
        for got, want, name in ((y.float(), ry.float(), "y"), (fin, rfin, "final state")):
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite {name}")
            excess = float(((got - want).abs() - tol * (1 + want.abs())).max())
            check(excess <= 0, f"{what}: {name} beyond {tol} abs + rel by {excess}")
        err = float((y.float() - ry.float()).abs().max())
        max_err = max(max_err, err)
        bf16 = dtype == torch.bfloat16
        if bf16:
            y2, fin2 = ops.ssd_scan(x, dt, a, bb, cc, q)
            check(torch.equal(y, y2) and torch.equal(fin, fin2), f"{what}: two calls differ")
            del y2, fin2
        big = s >= 1024
        row = {
            "kernel": "ssd_scan", "path": path, "shape": [b, s, h, p, n, q],
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err, "max_abs_err_final": float((fin - rfin).abs().max()),
            "max_abs_y": float(ry.float().abs().max()),
            "kernel_ms": cuda_ms(lambda: ops.ssd_scan(x, dt, a, bb, cc, q), reps=20 if big else 50),
            "plain_ms": cuda_ms(lambda: ssd_scan_ref(x, dt, a, bb, cc, q), reps=5 if big else 20,
                                warmup=1 if big else 5),
            "library_ms": None,
            **ssd_bound(b, s, h, p, n, q, dtype),
            "peak": ("bf16 tensor cores 989 TFLOP/s" if dtype == torch.bfloat16 else
                     "fp32 CUDA cores 67 TFLOP/s") + ", HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        if bf16:
            trace = device_breakdown(lambda: ops.ssd_scan(x, dt, a, bb, cc, q), row["kernel_ms"])
            moved = ssd_kernel_bytes(b, s, h, p, n, q)
            row.update({
                "bit_identical": True,
                "scratch_bytes": ssd_scratch_bytes(b, s, h, p, n, q),
                "sub_kernels": {k: {"ms": trace["port_kernels"].get(k, {}).get("ms"),
                                    "bytes": moved[k]} for k in SSD_BF16_KERNELS},
                "busy": trace["busy"],
            })
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, dt, a, bb, cc, y, fin, ry, rfin
        free_memory()
    return {"rows": rows, "max_abs_err": max_err}


# --------------------------------------------------------------------------
# The transformer paths
# --------------------------------------------------------------------------

def transformer_config(layers: int = TF_LAYERS):
    return dataclasses.replace(get_config(ARCH), num_layers=layers)


def transformer_pipeline_phase(
    device: torch.device, cfg, n_probes: int = TF_PROBES, seq_len: int = TF_SEQ,
    group_reps: int = 5,
) -> dict:
    """Profile -> select -> order -> serve on a transformer backbone.

    Launch counts are set to 0 just before the profile and before
    ``serve_batch``, and read just after each.
    """
    laps = Laps(device)
    mem = {}
    depth = N_BRANCH_POINTS + 1
    costs = transformer_block_costs(cfg, _split_layers(cfg.num_layers, depth), seq_len)
    gen_device = device if device.type == "cuda" else torch.device("cpu")

    # Affinity: profile each per-task network of the fully-separate graph.
    reset_peak(device)
    sep = TaskGraph.fully_separate(N_TASKS, N_BRANCH_POINTS)
    prog = build_transformer_program(
        sep, cfg, [N_CLASSES] * N_TASKS, seq_len,
        generator=torch.Generator(device=gen_device).manual_seed(0), device=device,
    )
    rng = np.random.default_rng(0)
    probes = torch.as_tensor(
        rng.integers(0, cfg.raw_vocab_size, (n_probes, seq_len)), device=device
    )
    laps.lap("build_profile_program")
    reset_launch_counts()
    profiles = [
        profile_task(branch_point_taps(prog, t, probes)) for t in range(N_TASKS)
    ]
    sync(device)
    profile_launches = launch_counts()
    laps.lap("profile")
    mem["profile_gb"] = peak_gb(device)
    aff = affinity_matrix(profiles).cpu().numpy()
    laps.lap("spearman")
    check_affinity(aff)
    del prog, profiles
    free_memory()

    # Task-graph selection and ordering, planned with the TPU hardware model
    # the reference pairs with transformer programs.
    sel, exact = select_and_order(aff, costs, TPU_V5E, laps, "transformer: ")

    # Serving: request groups through the block-cached engine.
    reset_peak(device)
    prog2 = build_transformer_program(
        sel.graph, cfg, [N_CLASSES] * N_TASKS, seq_len,
        generator=torch.Generator(device=gen_device).manual_seed(1), device=device,
    )
    engine = MultitaskEngine(prog2, hw=TPU_V5E)
    rng = np.random.default_rng(1)
    picks = rng.integers(0, len(SUBSETS), size=N_REQUESTS)
    tokens = rng.integers(0, cfg.raw_vocab_size, (N_REQUESTS, 1, seq_len)).astype(np.int32)
    requests = [MultitaskRequest(x=tokens[i], tasks=SUBSETS[s]) for i, s in enumerate(picks)]
    laps.lap("build_engine")
    plan = engine.plan_groups(requests)
    predicted = engine.predicted_group_stats(plan)
    laps.lap("plan")
    reset_launch_counts()
    responses = engine.serve_batch(requests)
    sync(device)
    serve_launches = launch_counts()
    laps.lap("serve")
    mem["serve_gb"] = peak_gb(device)
    max_err = check_served(engine, plan, requests, responses, predicted, device,
                           TF_TOL, "transformer ")
    check_beats_vanilla(prog2, torch.as_tensor(tokens[:2, 0], device=device), exact.order,
                        TPU_V5E, "transformer ")
    laps.lap("check")
    result = {
        "engine": engine, "plan": plan, "requests": requests, "laps": laps.seconds,
        "max_err": max_err, "mem": mem, "graph": sel.graph.partitions,
        "profile_launches": profile_launches, "serve_launches": serve_launches,
        "blocks_executed": engine.last_batch_stats.blocks_executed,
    }
    if device.type == "cuda":
        result["groups"] = time_groups(result, reps=group_reps, warmup=1)
        i = max(range(len(plan)),
                key=lambda j: len(engine.group_order(plan[j])) * plan[j].xs.shape[0])
        result["trace"] = {
            "group": {"tasks": result["groups"][i]["tasks"],
                      "padded": result["groups"][i]["padded"]},
            **device_breakdown(lambda: engine._execute_group(plan[i]),
                               result["groups"][i]["ms"]),
        }
    return result


def lm_phase(
    device: torch.device, cfg, batch: int = LM_BATCH, prompt_len: int = LM_PROMPT,
    steps: int = LM_STEPS, check_batch=None,
) -> dict:
    """``LMServer.generate`` on ``model.init`` of ``cfg``; then one prefill
    and one decode step with their launch counts, and the first decode step
    against ``forward`` over the prompt plus its token (on the first
    ``check_batch`` rows, all by default)."""
    laps = Laps(device)
    reset_peak(device)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=gen_device).manual_seed(2), device)
    prompts = np.random.default_rng(2).integers(
        0, cfg.raw_vocab_size, (batch, prompt_len)).astype(np.int32)
    server = LMServer(model, params)
    laps.lap("init")
    reset_launch_counts()
    tokens = server.generate(prompts, steps)
    sync(device)
    launches = launch_counts()
    laps.lap("generate")
    generate_gb = peak_gb(device)
    check(tokens.shape == (batch, steps), f"generated shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token ids out of range")

    reset_launch_counts()
    logits0, cache = model.prefill(params, prompts)
    sync(device)
    prefill_launches = launch_counts()
    tok = torch.argmax(logits0, dim=-1)
    check(np.array_equal(tok.cpu().numpy(), tokens[:, 0]), "first token differs from generate")
    cache = _grow_cache(model, cache, prompt_len + steps, prompt_len)
    reset_launch_counts()
    step_logits, _cache = model.decode_step(params, tok, cache, prompt_len)
    sync(device)
    decode_launches = launch_counts()
    rows = batch if check_batch is None else check_batch
    full, _aux = model.forward(params, torch.cat(
        [torch.as_tensor(prompts[:rows], device=device).long(), tok[:rows, None]], 1))
    ref = full[:, -1].float()
    del full
    err = float((step_logits[:rows].float() - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(step_logits).all()), "non-finite decode logits")
    check(err <= TF_TOL * scale,
          f"decode vs forward: max abs err {err} > {TF_TOL} x max |logit| {scale}")
    laps.lap("check")
    result = {"tokens": tokens, "launches": launches, "laps": laps.seconds,
              "prefill_launches": prefill_launches, "decode_launches": decode_launches,
              "decode_vs_forward_err": err, "max_abs_logit": scale, "check_rows": rows,
              "generate_gb": generate_gb, "mem_gb": peak_gb(device)}
    if device.type == "cuda":
        result["prefill_ms"] = cuda_ms(lambda: model.prefill(params, prompts), reps=5, warmup=1)
        result["decode_step_ms"] = cuda_ms(
            lambda: model.decode_step(params, tok, cache, prompt_len), reps=10, warmup=2)
        result["trace"] = {
            "prefill": device_breakdown(lambda: model.prefill(params, prompts),
                                        result["prefill_ms"]),
            "decode_step": device_breakdown(
                lambda: model.decode_step(params, tok, cache, prompt_len),
                result["decode_step_ms"]),
        }
    return result


def ssm_lm_phase(device: torch.device, cfg, batch: int, prompt_len: int, steps: int) -> dict:
    """``lm_phase`` on an SSM or hybrid config, checking that a prefill
    launches the SSD kernel once per Mamba2 layer and flash once per
    shared-attention invocation, and that decode launches neither (on the
    card; every count stays 0 on the CPU, where the plain versions run)."""
    res = lm_phase(device, cfg, batch, prompt_len, steps, check_batch=SSM_CHECK_BATCH)
    n_flash = cfg.num_layers // cfg.hybrid_attn_period if cfg.family == "hybrid" else 0
    expected = {"pearson_gram": 0, "flash_attention": n_flash, "ssd_scan": cfg.num_layers}
    if device.type != "cuda":
        expected = dict.fromkeys(expected, 0)
    for name, got in (("generate", res["launches"]), ("prefill", res["prefill_launches"])):
        check(got == expected, f"{cfg.name} {name}: launches {got}, expected {expected} "
              f"(one prefill: SSD once per Mamba2 layer, flash once per invocation)")
    check(not any(res["decode_launches"].values()),
          f"{cfg.name}: a decode step launched {res['decode_launches']}")
    print(json.dumps({
        "ssm_lm": {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
                   "prompt": prompt_len, "steps": steps, "launches": res["launches"],
                   "decode_launches": res["decode_launches"],
                   "prefill_ms": res.get("prefill_ms"),
                   "decode_step_ms": res.get("decode_step_ms"),
                   "decode_vs_forward_err": res["decode_vs_forward_err"],
                   "max_abs_logit": res["max_abs_logit"], "check_rows": res["check_rows"],
                   "seconds": res["laps"], "peak_memory_gb_generate": res["generate_gb"],
                   "peak_memory_gb": res["mem_gb"], "tokens_row0": res["tokens"][0].tolist()},
    }), flush=True)
    if "trace" in res:
        print(json.dumps({"ssm_lm_trace": {"arch": cfg.name, **res["trace"]}}), flush=True)
    return res


def launcher_phase(arch: str, steps: int = LAUNCHER_STEPS, extra_args=()) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch> --steps <steps>``,
    in-process (on the card, at the full config, unless ``extra_args`` say
    otherwise): its tokens/s line is printed and checked, with the launches
    of its one prefill."""
    argv = ["--arch", arch, "--steps", str(steps), *extra_args]
    buf = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        out = serve_launcher.main(argv)
    launches = launch_counts()
    text = buf.getvalue()
    print(text, end="", flush=True)
    check("tok/s" in text, f"the launcher printed no tokens/s line: {text!r}")
    check(out.shape[1] == steps, f"launcher generated {out.shape}")
    return {"launches": launches, "line": text.splitlines()[0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    for src, seconds in build_kernels().items():
        print(f"built {src} in {seconds:.1f} s", flush=True)
        for line in _build.ptxas_report(src):
            print(f"  ptxas {src}: {line}", flush=True)

    t0 = time.perf_counter()
    kernels = kernel_phase(device)
    flash = flash_phase(device)
    ssd = ssd_phase(device)
    print(json.dumps({"kernel_checks_seconds": time.perf_counter() - t0}), flush=True)

    # LeNet-5: profile -> select -> order -> serve.
    reset_launch_counts()
    result = pipeline_phase(device)
    lenet_launches = launch_counts()
    check(lenet_launches["pearson_gram"] == N_TASKS * N_BRANCH_POINTS,
          f"pearson kernel launched {lenet_launches['pearson_gram']} times on the LeNet "
          f"path, expected {N_TASKS * N_BRANCH_POINTS}")
    print(f"pipeline: pearson launches {lenet_launches['pearson_gram']}; serve_batch "
          f"{len(result['requests'])} requests in {len(result['plan'])} groups; "
          f"served vs per-block max abs err {result['max_err']:.3g}", flush=True)
    print(json.dumps({"pipeline_seconds": result["laps"]}), flush=True)
    for row in time_groups(result):
        print(json.dumps({"group": row}), flush=True)
    # The same engine and requests through sessions: the four policies, then
    # scripted faults.
    t0 = time.perf_counter()
    lenet_sessions = session_phase(result["engine"], result["requests"], device,
                                   PIPELINE_TOL, "lenet ")
    chaos_phase(result["engine"], result["requests"], lenet_sessions["window"]["responses"],
                device, PIPELINE_TOL, "lenet ")
    del result, lenet_sessions
    free_memory()
    # The quickstart's five steps at its reference sizes.
    qs_row = quickstart_phase(device)
    print(json.dumps({"lenet_session_and_quickstart_seconds": time.perf_counter() - t0}),
          flush=True)

    # mistral-nemo-12b, 8 layers: profile -> select -> order -> serve.
    device_breakdown(torch.cuda.synchronize, 1.0)  # the profiler's first session pays its start-up
    cfg = transformer_config()
    tf = transformer_pipeline_phase(device, cfg)
    prof, serve = tf["profile_launches"], tf["serve_launches"]
    check(prof["flash_attention"] == 2 * N_TASKS * N_BRANCH_POINTS,
          f"flash kernel launched {prof['flash_attention']} times in the transformer "
          f"profile, expected {2 * N_TASKS * N_BRANCH_POINTS}")
    check(prof["pearson_gram"] == N_TASKS * N_BRANCH_POINTS,
          f"pearson kernel launched {prof['pearson_gram']} times in the transformer profile")
    layers_per_block = cfg.num_layers // (N_BRANCH_POINTS + 1)
    check(serve["flash_attention"] == layers_per_block * tf["blocks_executed"],
          f"flash kernel launched {serve['flash_attention']} times in serve_batch, expected "
          f"{layers_per_block} x {tf['blocks_executed']} blocks executed")
    print(f"transformer pipeline: graph {tf['graph']}; flash launches profile "
          f"{prof['flash_attention']}, serve {serve['flash_attention']} "
          f"({tf['blocks_executed']} blocks executed); pearson launches "
          f"{prof['pearson_gram']}; served vs per-block max abs err {tf['max_err']:.3g}",
          flush=True)
    print(json.dumps({"transformer_pipeline_seconds": tf["laps"],
                      "peak_memory_gb": tf["mem"]}), flush=True)
    for row in tf["groups"]:
        print(json.dumps({"transformer_group": row}), flush=True)
    print(json.dumps({"transformer_group_trace": tf["trace"]}), flush=True)
    # The same engine and requests through sessions, then scripted faults.
    t0 = time.perf_counter()
    tf_sessions = session_phase(tf["engine"], tf["requests"], device, TF_TOL,
                                f"{ARCH} ", layers_per_block)
    tf_chaos = chaos_phase(tf["engine"], tf["requests"], tf_sessions["window"]["responses"],
                           device, TF_TOL, f"{ARCH} ")
    print(json.dumps({"transformer_session_seconds": time.perf_counter() - t0}), flush=True)
    session_flash = {name: v["row"]["launches"]["flash_attention"]
                     for name, v in tf_sessions.items()}
    del tf, tf_sessions
    free_memory()

    # mistral-nemo-12b, 8 layers: LMServer prefill + greedy decode.
    lm = lm_phase(device, cfg)
    check(lm["launches"]["flash_attention"] == cfg.num_layers,
          f"flash kernel launched {lm['launches']['flash_attention']} times in "
          f"generate, expected {cfg.num_layers} (one per layer of the prefill)")
    print(json.dumps({
        "lm": {"batch": LM_BATCH, "prompt": LM_PROMPT, "steps": LM_STEPS,
               "flash_launches": lm["launches"]["flash_attention"],
               "prefill_ms": lm["prefill_ms"], "decode_step_ms": lm["decode_step_ms"],
               "decode_vs_forward_err": lm["decode_vs_forward_err"],
               "max_abs_logit": lm["max_abs_logit"], "seconds": lm["laps"],
               "peak_memory_gb": lm["mem_gb"], "tokens_row0": lm["tokens"][0].tolist()},
    }), flush=True)
    print(json.dumps({"lm_trace": lm["trace"]}), flush=True)
    free_memory()

    # mamba2-780m and zamba2-2.7b at full width and depth: LMServer prefill
    # + greedy decode; then the serve launcher on mamba2-780m.
    mamba = ssm_lm_phase(device, get_config(MAMBA2[0]), *MAMBA2[1:])
    free_memory()
    zamba = ssm_lm_phase(device, get_config(ZAMBA2[0]), *ZAMBA2[1:])
    free_memory()
    launcher = launcher_phase(MAMBA2[0])
    check(launcher["launches"]["ssd_scan"] == get_config(MAMBA2[0]).num_layers,
          f"launcher: SSD launched {launcher['launches']['ssd_scan']} times")
    print(json.dumps({"launcher": launcher}), flush=True)
    print(json.dumps({"smoke_seconds": time.perf_counter() - t_start}), flush=True)

    pearson_row = kernels["rows"][0]
    transformer_pearson_row = next(r for r in kernels["rows"] if r["K"] == TF_PROBES)
    flash_row = flash["rows"][0]
    ssd_main = [r for r in ssd["rows"] if r["path"] in ("mamba2_prefill", "zamba2_prefill")]
    ssd_by_path = {"mamba2_prefill": mamba["launches"]["ssd_scan"],
                   "zamba2_prefill": zamba["launches"]["ssd_scan"],
                   "launcher": launcher["launches"]["ssd_scan"]}
    timed = ("kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{
        "name": "pearson_gram",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pearson_gram.cu",
        "replaces": "src/repro/kernels/pearson_affinity.py:71",
        "launches": (lenet_launches["pearson_gram"] + prof["pearson_gram"]
                     + qs_row["launches"]["pearson_gram"]),
        "launches_by_path": {"lenet_profile": lenet_launches["pearson_gram"],
                             "transformer_profile": prof["pearson_gram"],
                             "quickstart_profile": qs_row["launches"]["pearson_gram"]},
        "max_abs_err": kernels["max_abs_err"],
        "ms": pearson_row["kernel_ms"],
        "plain_ms": pearson_row["plain_ms"],
        "bound_ms": pearson_row["bound_ms"],
        "bound_by": pearson_row["bound_by"],
        "library_ms": pearson_row["library_ms"],
        "shape": [pearson_row["K"], pearson_row["F"]],
        "by_path": {path: {"shape": [r["K"], r["F"]], **{k: r[k] for k in timed}}
                    for path, r in (("lenet_profile", pearson_row),
                                    ("transformer_profile", transformer_pearson_row))},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": (prof["flash_attention"] + serve["flash_attention"]
                     + sum(session_flash.values())
                     + tf_chaos["launches"]["flash_attention"]
                     + lm["launches"]["flash_attention"] + zamba["launches"]["flash_attention"]),
        "launches_by_path": {"transformer_profile": prof["flash_attention"],
                             "transformer_serve": serve["flash_attention"],
                             **{f"transformer_session_{name}": n
                                for name, n in session_flash.items()},
                             "transformer_session_chaos": tf_chaos["launches"]["flash_attention"],
                             "lm_prefill": lm["launches"]["flash_attention"],
                             "zamba2_prefill": zamba["launches"]["flash_attention"]},
        "max_abs_err": flash["max_abs_err"],
        "ms": flash_row["kernel_ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "shape": flash_row["shape"],
        "by_path": {r["path"]: {k: r[k] for k in ("shape", *timed)} for r in flash["rows"]},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:100",
        "launches": sum(ssd_by_path.values()),
        "launches_by_path": ssd_by_path,
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd_main[0]["kernel_ms"],
        "plain_ms": ssd_main[0]["plain_ms"],
        "bound_ms": ssd_main[0]["bound_ms"],
        "bound_by": ssd_main[0]["bound_by"],
        "library_ms": None,
        "shape": ssd_main[0]["shape"],
        "by_path": {r["path"]: {k: r[k] for k in ("shape", *timed)} for r in ssd_main},
    }], "launch_counts": launch_counts()}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
