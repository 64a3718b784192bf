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
   same trace through a streamed session (``EnginePolicy(streaming=True)``:
   each group's weights copied from pinned host memory on a side CUDA
   stream behind the previous group's kernels), once more under a scripted
   "prefetch" fault, and through journaled sessions (a ``Journal`` on a
   ``FileJournalStore``) with power failures scripted at the "group",
   "suffix" and "prefetch" sites, each followed by
   ``ServingSession.recover``: with checkpoints and restarting from
   scratch; then a journaled session duty-cycled by an ``EnergyBudget``.
   Then the quickstart (``repro_torch.examples.quickstart``) runs its five
   steps at its reference sizes: 200 SGD steps, the profile, selection,
   ordering and Antler against Vanilla; then the block profiler on the card.
4. Drives the same path on a transformer backbone: mistral-nemo-12b at full
   width (d_model 5120, GQA 32/8, head_dim 160, bf16), its 40 layers cut to
   8, sequences of 128 tokens, 256 random-token probes, 4 blocks of 2 layers;
   then the same sessions as the LeNet engine's, streamed and journaled
   ones included (the journal in a ``MemoryJournalStore``).
5. Drives ``LMServer.generate`` on the same configuration: 4 prompts of 512
   tokens, 16 greedy decode steps; then ``ContinuousBatcher`` on the same
   weights: 10 requests (prompts of 64-512 tokens, 4-16 new tokens, drawn
   from a seeded generator) in waves of 4.
6. Drives ``LMServer.generate`` on mamba2-780m at full width and depth (48
   layers, bf16): 4 prompts of 2048 tokens, 32 greedy steps; then on
   zamba2-2.7b at full width and depth (54 layers, bf16): 4 prompts of 1024
   tokens, 16 steps.
7. Runs the serve launcher (``repro_torch.launch.serve``) in-process on
   mamba2-780m for a few steps; it prints its tokens/s line.
8. Drives Antler's pipeline on a MoE backbone: qwen2-moe-a2.7b at full
   width (60 routed experts top-4 + 4 shared, bf16), its 24 layers cut to
   8, as mistral's.  Then ``LMServer.generate`` on the MoE, VLM and
   enc-dec families: qwen2-moe-a2.7b at full depth (4 x 512 tokens, 16
   steps), mixtral-8x22b at 8 of its 56 layers (2 x 4608 tokens: the
   4096-token window engages and decode runs on the ring; 8 steps),
   chameleon-34b at full depth (48 layers, 4 x 512, 16 steps) and
   whisper-medium at full depth (1500 frames of normals, 4 x 32 tokens, 32
   steps); then the serve launcher on whisper-medium.
9. Prints one ``{"kernels": [...]}`` line, then the device line last.

Each path runs with every launch count set to 0 just before it and read
just after; the script checks that the kernels ran where the path runs
them (Pearson 15 times per profile, the quickstart's included; flash
attention 30 times in each transformer profile, twice per executed block
in serving and in every session — a journaled one's lost work included —,
once per decoder layer of a prefill and of each batcher wave's prefill (8,
24, 8, 48), 9 times in zamba2's, 72 times in whisper's (once per encoder
layer, twice per decoder layer); the SSD once per Mamba2 layer of a
prefill, 48 and 54; none in decode), that served counters equal the cost
model's prediction field for field (every session's too, faults,
streamed loads and checkpoint writes included), that served outputs match
the per-block executor, that every session request succeeds, that faulted
outputs match the fault-free session's, that streamed outputs are
bit-identical to the synchronous session's, that journaled sessions answer
every request exactly once through their power failures, resume an
interrupted group from its checkpoint depth and restore journaled
activations bit-exactly, that each batcher request's tokens equal
``LMServer.generate`` on its wave, that the quickstart's loss falls, that Antler beats Vanilla,
and that the first decode step agrees with ``forward``.  On a MoE that
check runs at a capacity factor under which nothing drops, one row at a
time, with prefill and decode taking forward's expert choices (bf16
roundings flip near ties), in bf16 at full depth and in fp32 on the
first two layers' weights, where the router logits are held to forward's
as well.  The flash kernel's bf16 rows on the main paths are held both
absolutely and against each query row's largest |output|.  Any failed
check raises.  Each session prints a JSON line: admission rounds, groups,
planning seconds, its wall seconds to the end of the drain, admission
waits (simulated seconds), weight bytes loaded, the device's busy share
over the session, and how many rounds were planned while the card still
had queued work.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  TF32 is switched off for matmuls and cuDNN:
the checks hold fp32 to 1e-5, 2e-5, 2e-4 and 3e-3.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
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
from repro_torch._device import tree_map  # noqa: E402
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
from repro_torch.core.executor import ActivationCheckpoint  # noqa: E402
from repro_torch.core.profiler import profile_program_blocks  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AffinityPolicy, ContinuousBatcher, EnergyBudget, EnginePolicy, FaultInjector,
    FileJournalStore, GenRequest, GreedyBatchPolicy, InjectedFault, Journal, LMServer,
    MemoryJournalStore, MultitaskEngine, MultitaskRequest, PowerFailure,
    PowerFailureInjector, RetryPolicy, ServingSession, SloAwarePolicy, WindowPolicy,
)
from repro_torch.serving.engine import _grow_cache  # noqa: E402

N_TASKS, N_CLASSES, N_BRANCH_POINTS = 5, 4, 3
N_PROBES = 512
N_REQUESTS = 48
SUBSETS = (None, (0, 1), (2, 3, 4), (1, 3), (4,))
# (K, F): the LeNet path's three branch points at K = 512, the transformer
# profiles' taps (K = 256 probes, F = 128 tokens x d_model: mistral's 5120,
# qwen2-moe's 2048), then ragged edges.
PEARSON_SHAPES = ((512, 1568), (512, 784), (512, 64), (256, 128 * 5120), (256, 128 * 2048),
                  (37, 100), (64, 300))
FP32_TOL, BF16_TOL, PIPELINE_TOL = 1e-5, 5e-2, 1e-5
# Flash attention: the reference sweep's tolerances (tests/test_kernels.py).
FLASH_FP32_TOL, FLASH_BF16_TOL = 2e-5, 2e-2
# And, on the main paths' bf16 shapes, each query row's error against that
# row's largest |output|: over thousands of keys an output row is small
# (|out| ~ 1 / sqrt(T / e) for unit normals), so the absolute bound alone
# would not see a wrong window or a wrong share of the padded keys.
FLASH_BF16_ROW_TOL = 2e-2
# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores,
# dense bf16 on the tensor cores, HBM3.
FP32_PEAK_FLOPS, BF16_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 989e12, 3.35e12

# The transformer paths: mistral-nemo-12b at full width, depth 40 -> 8.
ARCH, TF_LAYERS, TF_SEQ, TF_PROBES = "mistral-nemo-12b", 8, 128, 256
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 512, 16
TF_TOL = 5e-2  # bf16 activations: served vs per-block, decode vs forward
# The continuous batcher on the same configuration: requests in waves of
# BATCHER_SLOTS, prompt lengths and new tokens drawn by ``batcher_plan``.
BATCHER_SLOTS, BATCHER_REQUESTS = 4, 10


def batcher_plan(n: int = BATCHER_REQUESTS, seed: int = 4):
    """Prompt lengths (64-512) and ``max_new_tokens`` (4-16) of the batcher
    phase's requests, and the generator that then draws their tokens."""
    rng = np.random.default_rng(seed)
    return rng.integers(64, 513, n), rng.integers(4, 17, n), rng


def batcher_waves(slots: int = BATCHER_SLOTS):
    """(rows, longest prompt) of each wave: requests in arrival order,
    ``slots`` at a time."""
    lengths, _news, _rng = batcher_plan()
    return [(len(lengths[w:w + slots]), int(max(lengths[w:w + slots])))
            for w in range(0, len(lengths), slots)]


# The wave whose prefill is largest (rows x prompt).
BATCHER_WAVE = max(batcher_waves(), key=lambda w: w[0] * w[1])
# Flash shapes of the main paths, model layout, bf16: (path, B, S, T, Hq, Hk,
# d, causal, window, real keys).  mistral's serving group of 16, LM prefill
# and profile batch; zamba2's prefill; the same three of qwen2-moe; the
# mixtral, chameleon and whisper prefills; the batcher's largest wave.  Whisper's encoder and
# cross-attention see 1500 frames zero-padded to 2048 keys, as the
# reference's chunked attention pads them (``models/encdec.py``).
FLASH_MAIN = (
    ("serve_group", 16, 128, 128, 32, 8, 160, True, None, None),
    ("lm_prefill", 4, 512, 512, 32, 8, 160, True, None, None),
    ("profile", 256, 128, 128, 32, 8, 160, True, None, None),
    ("zamba2_prefill", 4, 1024, 1024, 32, 32, 80, True, None, None),
    ("qwen2_serve_group", 16, 128, 128, 16, 16, 128, True, None, None),
    ("qwen2_profile", 256, 128, 128, 16, 16, 128, True, None, None),
    ("qwen2_prefill", 4, 512, 512, 16, 16, 128, True, None, None),
    ("mixtral_prefill", 2, 4608, 4608, 48, 8, 128, True, 4096, None),
    ("chameleon_prefill", 4, 512, 512, 64, 8, 128, True, None, None),
    ("whisper_encoder", 4, 1500, 2048, 16, 16, 64, False, None, 1500),
    ("whisper_cross", 4, 32, 2048, 16, 16, 64, False, None, 1500),
    ("batcher_wave", BATCHER_WAVE[0], BATCHER_WAVE[1], BATCHER_WAVE[1], 32, 8, 160, True, None,
     None),
)
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
# The MoE pipeline: qwen2-moe-a2.7b at full width, depth 24 -> 8 (4 blocks
# of 2 layers), otherwise as mistral's.
MOE_ARCH, MOE_LAYERS = "qwen2-moe-a2.7b", 8
# The MoE, VLM and enc-dec LM paths: (arch, layers (None: all), batch,
# prompt, steps, rows of the decode-vs-forward check).  mixtral's prompt
# passes its 4096-token window, so prefill rolls its cache into the ring.
FAMILY_LMS = (
    ("qwen2-moe-a2.7b", None, 4, 512, 16, 4),
    ("mixtral-8x22b", 8, 2, 4608, 8, 2),
    ("chameleon-34b", None, 4, 512, 16, 4),
    ("whisper-medium", None, 4, 32, 32, 4),
)
WHISPER_FRAMES = 1500
# A MoE's decode-vs-forward gate: fp32 on its first layers, at the
# reference's decode tolerance (abs + rel).
MOE_CHECK_LAYERS, DECODE_FP32_TOL = 2, 3e-3
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
# Weight streaming and intermittent power
# --------------------------------------------------------------------------

# The streamed and journaled sessions run the window policy's trace.
STREAM_POLICY = "window"
# Scripted "prefetch" faults of the streamed session (invocation indices).
PREFETCH_FAULTS = {"prefetch": {0}}
# Power failures of the journaled sessions: invocation indices per site,
# counted across the reboots they cause (the injector outlives sessions).
POWER_SCRIPT = {"group": (4,), "suffix": (2,), "prefetch": (3,)}
# The streamed and journaled phases stay below the smoke's largest peak
# before they came (mixtral's decode-vs-forward check, GB).
STREAM_PEAK_LIMIT_GB = 75.42


def overlap_of_copies(prof) -> dict:
    """From a device trace: milliseconds of host-to-device copies, of
    kernels, and of copies that ran while some kernel ran."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append(span)
        elif not e.name.startswith("Memcpy") and not e.name.startswith("Memset"):
            kernels.append(span)
    merged = []
    for a, b in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    overlap = 0.0
    for a, b in copies:
        for ka, kb in merged:
            if kb <= a:
                continue
            if ka >= b:
                break
            overlap += min(b, kb) - max(a, ka)
    return {"copy_ms": sum(b - a for a, b in copies) / 1e3,
            "copy_events": len(copies),
            "kernel_ms": sum(b - a for a, b in merged) / 1e3,
            "copy_overlapping_kernels_ms": overlap / 1e3}


def streaming_phase(engine, requests, sync_responses, device, label: str,
                    layers_per_block=None) -> dict:
    """The phase's requests through a streamed session (window policy) on an
    engine sharing ``engine``'s program: outputs bit-identical to the
    synchronous session's (``sync_responses``), ``stats == predicted`` with
    ``prefetched_bytes > 0``, flash once per layer of every executed block;
    then once more with a scripted ``"prefetch"`` fault, which degrades one
    group to synchronous loads while every request is served.  Prints the
    staged bytes, the copies' measured device time and GB/s beside the
    modelled stall, whether the copies overlapped kernels, and the peak."""
    cuda = device.type == "cuda"
    reset_peak(device)
    t0 = time.perf_counter()
    # The streaming engine shares the program; its pinned host copy is
    # built here, once.
    strm = MultitaskEngine(engine.program, hw=engine.hw, policy=EnginePolicy(streaming=True))
    streamer = strm.executor.streamer
    build_seconds = time.perf_counter() - t0
    policy = SESSION_POLICIES[STREAM_POLICY]
    logged = len(streamer.copy_log)
    reset_launch_counts()
    session, responses, by_request, groups, seconds, _busy = serve_session(
        strm, requests, policy)
    launches = launch_counts()
    check(session.stats == session.predicted,
          f"{label}streamed session counters {session.stats} != predicted {session.predicted}")
    check(session.stats.prefetched_bytes > 0 and session.prefetches_issued > 0,
          f"{label}streamed session prefetched nothing ({session.prefetches_issued} prefetches)")
    check(session.prefetch_scheduled_bytes == session.stats.prefetched_bytes,
          f"{label}scheduled {session.prefetch_scheduled_bytes} B, prefetched "
          f"{session.stats.prefetched_bytes} B")
    for got, want in zip(responses, sync_responses):
        check(set(got.outputs) == set(want.outputs), f"{label}streamed: tasks differ")
        for t, y in got.outputs.items():
            check(torch.equal(y, want.outputs[t]),
                  f"{label}streamed output of task {t} differs from the synchronous session's "
                  f"(max abs {float((y.float() - want.outputs[t].float()).abs().max())})")
    if layers_per_block is not None and cuda:
        check(launches["flash_attention"] == layers_per_block * session.stats.blocks_executed,
              f"{label}streamed: flash launched {launches['flash_attention']} times, expected "
              f"{layers_per_block} x {session.stats.blocks_executed} blocks")
    copies = list(streamer.copy_log)[logged:]
    sync(device)
    copy_bytes = sum(n for n, _s, _e in copies)
    copy_ms = sum(s.elapsed_time(e) for _n, s, e in copies) if cuda else 0.0

    # A scripted "prefetch" fault: that group loads synchronously.
    injector = FaultInjector(script=PREFETCH_FAULTS)
    f_session, f_responses, _b, _g, f_seconds, _busy = serve_session(
        strm, requests, policy, injector)
    check(injector.injected["prefetch"] == len(PREFETCH_FAULTS["prefetch"])
          and f_session.prefetch_failures == len(PREFETCH_FAULTS["prefetch"]),
          f"{label}prefetch faults: injected {injector.injected}, session counted "
          f"{f_session.prefetch_failures}")
    check(isinstance(f_session.last_prefetch_error, InjectedFault),
          f"{label}a prefetch failed with {f_session.last_prefetch_error!r}")
    check(f_session.stats == f_session.predicted,
          f"{label}faulted streamed session counters != predicted")
    check(f_session.stats.weight_bytes_loaded == session.stats.weight_bytes_loaded
          and f_session.stats.prefetched_bytes <= session.stats.prefetched_bytes,
          f"{label}the prefetch fault did not move loads to the synchronous path")
    for got, want in zip(f_responses, sync_responses):
        for t, y in got.outputs.items():
            check(torch.equal(y, want.outputs[t]), f"{label}faulted streamed output differs")

    row = {"engine": label.strip(), "policy": STREAM_POLICY, "groups": session.groups_executed,
           "prefetches": session.prefetches_issued,
           "prefetched_bytes_modelled": session.stats.prefetched_bytes,
           "weight_bytes_loaded": session.stats.weight_bytes_loaded,
           "stream_stall_seconds_modelled": session.stats.stream_stall_seconds,
           "modelled_on": engine.hw.name, "drain_seconds": seconds,
           "faulted_drain_seconds": f_seconds,
           "faulted_prefetched_bytes_modelled": f_session.stats.prefetched_bytes,
           "launches": launches, "bit_identical_to_synchronous": True,
           "pinned_bytes": streamer.pinned_bytes,
           "pinned_copy_seconds": streamer.prepare_seconds,
           "engine_build_seconds": build_seconds}
    if cuda:
        peak = peak_gb(device)
        check(peak < STREAM_PEAK_LIMIT_GB,
              f"{label}streaming peak {peak} GB >= {STREAM_PEAK_LIMIT_GB} GB")
        row.update(copied_bytes=copy_bytes, copy_device_ms=copy_ms,
                   copy_gb_per_s=copy_bytes / max(copy_ms, 1e-9) / 1e6,
                   peak_memory_gb=peak)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve_session(strm, requests, policy)
            torch.cuda.synchronize()
        row["trace"] = overlap_of_copies(prof)
    print(json.dumps({"streaming": row}), flush=True)
    return {"row": row, "engine": strm, "responses": responses}


class TimedJournal(Journal):
    """A :class:`Journal` that times its writes (the host copy of each
    payload included — a CUDA tensor's waits for the stream) and counts the
    payload bytes it journaled."""

    def __init__(self, store):
        super().__init__(store)
        self.seconds = {}
        self.bytes = 0
        self.writes = {}

    def _timed(self, kind, fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0
        self.writes[kind] = self.writes.get(kind, 0) + 1

    @staticmethod
    def _nbytes(value) -> int:
        if isinstance(value, torch.Tensor):
            return value.numel() * value.element_size()
        return int(np.asarray(value).nbytes)

    def admit(self, seq, x, *args, **kwargs):
        self.bytes += self._nbytes(x)
        self._timed("admit", super().admit, seq, x, *args, **kwargs)

    def checkpoint(self, group_id, pos, task, depth, node, value, act_shape):
        self.bytes += self._nbytes(value)
        self._timed("checkpoint", super().checkpoint, group_id, pos, task, depth, node, value,
                    act_shape)

    def group_commit(self, group_id, seqs, outputs, residency, stats):
        self.bytes += sum(self._nbytes(v) for slot in outputs for v in slot.values())
        self._timed("group_commit", super().group_commit, group_id, seqs, outputs, residency,
                    stats)


def journaled_session(engine, requests, policy, journal, injector, use_checkpoints: bool,
                      energy=None):
    """Serve ``requests`` (bursts on a simulated clock, as ``serve_session``)
    through a journaled session of ``engine`` with ``injector`` armed.  A
    :class:`PowerFailure` — and only that — out of a pump or a recovery
    reboots: the executor is reset and ``ServingSession.recover`` rebuilds
    the session from the journal; the remaining requests go to the new
    session.  Returns the last session and what each death and recovery
    cost."""
    engine.executor.reset()
    engine.power_injector = injector
    clock = SimClock()
    kwargs = dict(policy=policy, clock=clock, sleep=lambda _s: None, retry=RetryPolicy(),
                  energy=energy)
    resumes, deaths, recovery_seconds, lost_blocks = [], [], [], 0
    execute = engine._execute_group

    def recorded(group, *args, **kw):
        resumes.append(kw.get("first_task_resume", 0))
        return execute(group, *args, **kw)

    engine._execute_group = recorded
    session = engine.session(journal=journal, checkpointing=use_checkpoints, **kwargs)
    incarnation_stats = []

    def died(err):
        nonlocal lost_blocks
        ctx = err.context
        partial = ctx.get("stats")
        if partial is not None:
            lost = partial.blocks_executed
            if err.site == "suffix":  # charged upfront: the cut's remainder never ran
                lost -= engine.program.graph.depth - 1 - ctx["depth"]
            lost_blocks += lost
        else:
            lost = 0
        deaths.append({"site": err.site, "index": err.index, "blocks_lost": lost})

    def reboot():
        while True:
            engine.executor.reset()
            sync(engine.device)
            t0 = time.perf_counter()
            try:
                new = ServingSession.recover(journal, engine, use_checkpoints=use_checkpoints,
                                             **kwargs)
            except PowerFailure as err:
                died(err)
                continue
            sync(engine.device)
            recovery_seconds.append(time.perf_counter() - t0)
            return new

    def pump(call):
        nonlocal session
        while True:
            try:
                call(session)
                return
            except PowerFailure as err:
                check(session.stats == session.predicted,
                      "a journaled session's counters differ from its prediction at death")
                incarnation_stats.append(session.stats)
                died(err)
                session = reboot()
                if call is not ServingSession.drain:
                    return

    try:
        sync(engine.device)
        t0 = time.perf_counter()
        for i, r in enumerate(requests):
            if i and i % BURST == 0:
                pump(ServingSession.step)
                clock.t += BURST_DT
            fut = session.submit(MultitaskRequest(
                x=r.x, tasks=r.tasks, tenant=("a", "b", "c")[i % 3],
                deadline=clock.t + DEADLINE_IN if i % 4 == 0 else None))
            check(fut.seq == i, f"request {i} journaled as seq {fut.seq}")
        pump(ServingSession.step)
        clock.t += BURST_DT
        pump(ServingSession.drain)
        sync(engine.device)
        seconds = time.perf_counter() - t0
    finally:
        del engine._execute_group
        engine.power_injector = None
    check(session.stats == session.predicted,
          f"journaled session counters {session.stats} != predicted {session.predicted}")
    incarnation_stats.append(session.stats)
    return {"session": session, "seconds": seconds, "deaths": deaths,
            "recovery_seconds": recovery_seconds, "resumes": resumes,
            "lost_blocks": lost_blocks, "incarnation_stats": incarnation_stats}


def check_exactly_once(journal, n: int, label: str) -> dict:
    """Every request answered exactly once: one commit per group, each seq
    in one commit, all ``n`` seqs answered, none failed."""
    records = journal.store.records()
    commits = [r for r in records if r["kind"] == "group_commit"]
    gids = [r["group_id"] for r in commits]
    seqs = [s for r in commits for s in r["seqs"]]
    check(len(gids) == len(set(gids)), f"{label}a group committed twice")
    check(sorted(seqs) == list(range(n)),
          f"{label}{len(seqs)} answers for {n} requests ({len(set(seqs))} distinct)")
    check(not any(r["kind"] == "request_failed" for r in records),
          f"{label}a request failed durably")
    return journal.replay()


def intermittent_phase(engine, requests, clean, device, tol: float, label: str,
                       store_kind: str, layers_per_block=None, energy: bool = False) -> dict:
    """Journaled sessions of ``engine`` (a streaming engine) over the phase's
    requests with power failures scripted at the "group", "suffix" and
    "prefetch" sites, each death followed by ``recover``: once with
    checkpoints and once restarting interrupted groups from scratch.  Gates:
    the deaths the script schedules happen, every request is answered
    exactly once, outputs match the clean session's within ``tol``, each
    incarnation's counters equal its prediction (checkpoint bytes included),
    a checkpointed recovery resumes its group past depth 0, the journaled
    activations restore bit-exactly (through the file format too), and
    flash ran once per layer of every block executed (lost work included).
    ``clean`` is the clean session's entry of :func:`session_phase` (its
    responses, and its row's blocks executed, from which the blocks run
    beyond it are counted).  With ``energy`` a budget then duty-cycles a
    journaled session."""
    import tempfile

    cuda = device.type == "cuda"
    policy = SESSION_POLICIES[STREAM_POLICY]
    graph_depth = engine.program.graph.depth
    clean_responses = clean["responses"]
    out, tmp = {}, tempfile.TemporaryDirectory()
    try:
        for arm, use_ck in (("checkpoints", True), ("scratch", False)):
            store = (FileJournalStore(f"{tmp.name}/{arm}.jsonl") if store_kind == "file"
                     else MemoryJournalStore())
            journal = TimedJournal(store)
            injector = PowerFailureInjector(script=POWER_SCRIPT)
            reset_launch_counts()
            reset_peak(device)
            res = journaled_session(engine, requests, policy, journal, injector, use_ck)
            launches = launch_counts()
            what = f"{label}intermittent ({arm}) "
            scheduled = sum(1 for site, idx in POWER_SCRIPT.items() for i in idx
                            if i < injector.invocations[site])
            check(len(res["deaths"]) == injector.total_injected == scheduled,
                  f"{what}deaths {res['deaths']}, injected {injector.injected}, "
                  f"scheduled {scheduled}")
            expected_sites = POWER_SCRIPT if use_ck else {"group": 1, "prefetch": 1}
            check(all(injector.injected[s] >= 1 for s in expected_sites),
                  f"{what}a scripted site never fired: {injector.injected}")
            state = check_exactly_once(journal, len(requests), what)
            max_err = 0.0
            for seq, want in enumerate(clean_responses):
                got = state.responses[seq]["outputs"]
                check(set(got) == set(want.outputs), f"{what}tasks of {seq} differ")
                for t, y in got.items():
                    max_err = max(max_err, float(
                        (y.to(device).float() - want.outputs[t].float()).abs().max()))
            check(max_err <= tol, f"{what}outputs vs the clean session: max abs {max_err}")
            executed = sum(s.blocks_executed for s in res["incarnation_stats"])
            if layers_per_block is not None and cuda:
                ran = executed + res["lost_blocks"]
                check(launches["flash_attention"] == layers_per_block * ran,
                      f"{what}flash launched {launches['flash_attention']} times, expected "
                      f"{layers_per_block} x {ran} blocks")
            ckpt_bytes = sum(s.checkpoint_bytes for s in res["incarnation_stats"])
            resumed = [r for r in res["resumes"] if r > 0]
            restored = None
            if use_ck:
                check(ckpt_bytes > 0, f"{what}no checkpoint was written")
                check(len(resumed) >= 1 and all(0 < r < graph_depth + 1 for r in resumed),
                      f"{what}no recovered group resumed from its checkpoint: {res['resumes']}")
                ck = next(r for r in journal.store.records() if r["kind"] == "checkpoint")
                value = ck["value"]
                # The file format too: the record through a fresh file store.
                path = f"{tmp.name}/{arm}-checkpoint.jsonl"
                FileJournalStore(path).append(ck)
                decoded = FileJournalStore(path).records()[0]["value"]
                ex = TaskGraphExecutor(engine.program)
                node = (int(ck["node"][0]), tuple(int(t) for t in ck["node"][1]))
                for v in (value, decoded):
                    ex.restore_activation(ActivationCheckpoint(
                        int(ck["depth"]), node, v, tuple(ck["act_shape"])))
                    back = ex._activations[int(ck["depth"])]
                    bits = {2: torch.int16, 4: torch.int32}[back.element_size()]
                    check(back.device == engine.device and back.dtype == value.dtype
                          and torch.equal(back.cpu().view(bits), value.view(bits)),
                          f"{what}a journaled {value.dtype} activation did not restore "
                          "bit-exactly")
                restored = str(value.dtype).removeprefix("torch.")
            else:
                check(ckpt_bytes == 0 and not resumed, f"{what}the scratch arm checkpointed")
            check(peak_gb(device) < STREAM_PEAK_LIMIT_GB,
                  f"{what}peak {peak_gb(device)} GB >= {STREAM_PEAK_LIMIT_GB} GB")
            writes = journal.writes.get("checkpoint", 0)
            row = {"engine": label.strip(), "arm": arm, "store": store_kind,
                   "deaths": res["deaths"], "injected": dict(injector.injected),
                   "invocations": dict(injector.invocations),
                   "recoveries": len(res["recovery_seconds"]),
                   "recovery_seconds": res["recovery_seconds"],
                   "resumed_first_task_at_depth": resumed,
                   "blocks_executed": executed, "blocks_lost": res["lost_blocks"],
                   "blocks_executed_clean": clean["row"]["blocks_executed"],
                   "blocks_beyond_clean": (executed + res["lost_blocks"]
                                           - clean["row"]["blocks_executed"]),
                   "checkpoint_bytes_modelled": ckpt_bytes,
                   "journal_payload_bytes": journal.bytes,
                   "journal_write_seconds": journal.seconds, "journal_writes": journal.writes,
                   "checkpoint_write_seconds_each": (
                       journal.seconds.get("checkpoint", 0.0) / writes if writes else None),
                   "journal_file_bytes": (os.path.getsize(store.path)
                                          if store_kind == "file" else None),
                   "activation_restored_bit_exactly": restored,
                   "max_abs_err_vs_clean": max_err, "drain_seconds": res["seconds"],
                   "launches": launches, "peak_memory_gb": peak_gb(device)}
            out[arm] = row
        if energy:
            out["energy"] = energy_phase(engine, requests, clean_responses, device, tol, label,
                                         tmp.name)
    finally:
        tmp.cleanup()
    for arm in ("checkpoints", "scratch"):
        print(json.dumps({"intermittent": out[arm]}), flush=True)
    return out


def energy_phase(engine, requests, clean_responses, device, tol: float, label: str,
                 tmpdir: str) -> dict:
    """A journaled session whose pump an :class:`EnergyBudget` duty-cycles:
    the capacitor holds twice the all-tasks group's predicted joules at the
    largest batch shape, starts empty, and the (simulated) harvest refills
    it; every group pauses for harvest, none fails."""
    hw, order = engine.hw, engine.order
    need = engine.cost_model.predicted_stats(
        order, batch_size=max(engine.scheduler.batch_shapes)).energy(hw)
    budget = EnergyBudget(capacity_joules=2.0 * need, harvest_watts=need, initial_joules=0.0)
    journal = TimedJournal(FileJournalStore(f"{tmpdir}/energy.jsonl"))
    res = journaled_session(engine, requests, SESSION_POLICIES[STREAM_POLICY], journal, None,
                            True, energy=budget)
    session = res["session"]
    check(session.energy_pauses > 0 and session.groups_failed == 0,
          f"{label}energy: {session.energy_pauses} pauses, {session.groups_failed} failed groups")
    state = check_exactly_once(journal, len(requests), f"{label}energy ")
    max_err = max(float((y.to(device).float() - clean.outputs[t].float()).abs().max())
                  for seq, clean in enumerate(clean_responses)
                  for t, y in state.responses[seq]["outputs"].items())
    check(max_err <= tol, f"{label}energy: outputs vs the clean session: max abs {max_err}")
    row = {"engine": label.strip(), "capacity_joules": budget.capacity_joules,
           "harvest_watts": budget.harvest_watts, "modelled_on": hw.name,
           "pauses": session.energy_pauses, "paused_seconds_sim": session.energy_paused_seconds,
           "drained_joules": budget.drained_joules, "groups": session.groups_executed,
           "max_abs_err_vs_clean": max_err}
    print(json.dumps({"energy": row}), flush=True)
    return row


# --------------------------------------------------------------------------
# Continuous batching
# --------------------------------------------------------------------------

def batcher_phase(device: torch.device, model, params, cfg) -> dict:
    """``ContinuousBatcher`` over ``BATCHER_REQUESTS`` requests in waves of
    ``BATCHER_SLOTS``: each request's tokens equal ``LMServer.generate`` on
    its own wave's padded prompts, cut to its steps; flash ran once per
    layer of each wave's prefill.  Prints each wave's prefill ms, a decode
    step's ms, tokens/s and the device's busy share."""
    lengths, news, rng = batcher_plan()
    requests = [GenRequest(uid=i, prompt=rng.integers(0, cfg.raw_vocab_size, int(n)).astype(
        np.int32), max_new_tokens=int(m)) for i, (n, m) in enumerate(zip(lengths, news))]

    def run():
        cb = ContinuousBatcher(model, params, slots=BATCHER_SLOTS, max_len=1024)
        for r in requests:
            cb.submit(r)
        return cb.run()

    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    results = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    waves = [requests[w:w + BATCHER_SLOTS] for w in range(0, len(requests), BATCHER_SLOTS)]
    expected = cfg.num_layers * len(waves) if device.type == "cuda" else 0
    check(launches["flash_attention"] == expected,
          f"batcher: flash launched {launches['flash_attention']} times, expected {expected} "
          f"({cfg.num_layers} per wave's prefill)")
    by_uid = {r.uid: r for r in results}
    check(sorted(by_uid) == list(range(len(requests))), "batcher: results missing")
    server = LMServer(model, params)
    wave_rows = []
    for wave in waves:
        toks = ContinuousBatcher.wave_tokens(wave)
        gen = server.generate(toks, max(r.max_new_tokens for r in wave))
        for i, r in enumerate(wave):
            got = by_uid[r.uid]
            check(got.steps == r.max_new_tokens and np.array_equal(
                got.tokens, gen[i, :r.max_new_tokens]),
                f"batcher: request {r.uid}'s tokens differ from generate on its wave")
        row = {"rows": len(wave), "prompt": int(toks.shape[1]),
               "steps": max(r.max_new_tokens for r in wave)}
        if device.type == "cuda":
            row["prefill_ms"] = cuda_ms(lambda: model.prefill(params, toks), reps=3, warmup=1)
        wave_rows.append(row)
    tokens = sum(r.steps for r in results)
    out = {"requests": len(requests), "slots": BATCHER_SLOTS, "waves": wave_rows,
           "tokens": tokens, "seconds": seconds, "tokens_per_s": tokens / seconds,
           "launches": launches}
    if device.type == "cuda":
        toks = ContinuousBatcher.wave_tokens(waves[0])
        _l, cache = model.prefill(params, toks)
        cache = _grow_cache(model, cache, toks.shape[1] + 16, toks.shape[1])
        tok = torch.zeros(len(waves[0]), dtype=torch.long, device=device)
        out["decode_step_ms"] = cuda_ms(
            lambda: model.decode_step(params, tok, cache, toks.shape[1]), reps=10, warmup=2)
        del cache
        trace = device_breakdown(run, seconds * 1e3, warm=False, cpu=False)
        out.update(busy=trace["busy"], device_ms=trace["device_ms"], kernels=trace["kernels"])
    print(json.dumps({"batcher": out}), flush=True)
    return out


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


def sdpa_call(q, k, v, causal: bool, window):
    """One ``scaled_dot_product_attention`` call on model-layout tensors
    computing what the kernel computes (a boolean mask for a window): the
    yardstick only."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = (qp - kp < window) & ((qp >= kp) if causal else True)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def flash_phase(device: torch.device) -> dict:
    """Flash kernel vs its plain version at the main paths' shapes (timed,
    with SDPA as the yardstick) and at ragged / windowed ones."""
    rng = np.random.default_rng(1)
    rows, max_err = [], 0.0
    for name, b, s, t, hq, hk, d, causal, window, real_t in FLASH_MAIN:
        q = _randn(rng, (b, s, hq, d), torch.bfloat16, device)
        k = _randn(rng, (b, t, hk, d), torch.bfloat16, device)
        v = _randn(rng, (b, t, hk, d), torch.bfloat16, device)
        if real_t is not None:  # the reference's zero keys past the real ones
            k[:, real_t:] = 0
            v[:, real_t:] = 0
        out = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        plain = flash_attention_bhsd_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        diff = (out.float() - plain.float()).abs()
        err = float(diff.max())
        row_max = plain.float().abs().amax(dim=-1)
        row_err = float((diff.amax(dim=-1) / row_max.clamp_min(1e-30)).max())
        plain_abs = float(row_max.max())
        check(err <= FLASH_BF16_TOL, f"flash bf16 {name}: max abs err {err} > {FLASH_BF16_TOL}")
        check(row_err <= FLASH_BF16_ROW_TOL,
              f"flash bf16 {name}: a query row's max abs err is {row_err} of its largest "
              f"|output|, > {FLASH_BF16_ROW_TOL} (max |plain| {plain_abs})")
        max_err = max(max_err, err)
        del out, plain, diff, row_max
        library = sdpa_call(q, k, v, causal, window)
        big = s * t > 4096 * 4096  # the plain version's scores take GBs: fewer calls
        row = {
            "kernel": "flash_attention", "path": name, "shape": [b * hq, s, t, d],
            "B": b, "S": s, "T": t, "Hq": hq, "Hk": hk, "d": d, "causal": causal,
            "window": window, "real_keys": real_t, "dtype": "bfloat16",
            "max_abs_err": err, "max_row_rel_err": row_err, "max_abs_plain": plain_abs,
            "kernel_ms": cuda_ms(
                lambda: ops.flash_attention_bhsd(q, k, v, causal=causal, window=window), reps=20),
            "kernel_host_ms": host_ms(
                lambda: ops.flash_attention_bhsd(q, k, v, causal=causal, window=window), reps=20),
            "plain_ms": cuda_ms(
                lambda: flash_attention_bhsd_ref(q, k, v, causal=causal, window=window),
                reps=3 if big else 10, warmup=1 if big else 5),
            # One library call computing the same attention: the yardstick only.
            "library_ms": cuda_ms(library, reps=20),
            "library_host_ms": host_ms(library, reps=20),
            **flash_bound(q, k, causal, window),
            "peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, library
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
    group_reps: int = 5, label: str = "transformer",
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
    sel, exact = select_and_order(aff, costs, TPU_V5E, laps, f"{label}: ")

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
                           TF_TOL, f"{label} ")
    check_beats_vanilla(prog2, torch.as_tensor(tokens[:2, 0], device=device), exact.order,
                        TPU_V5E, f"{label} ")
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


@contextlib.contextmanager
def routing(forced=None):
    """Every MoE layer's fp32 router logits and its own top-k expert ids
    while inside, in call order (``models/moe.py::route_logits``, wrapped
    and restored).  With ``forced``, a function of the call's index and
    logits (..., E) giving expert ids (..., k), each layer takes those
    experts instead, its gates renormalised over its own logits at them."""
    from repro_torch.models import moe

    seen, real = [], moe.route_logits

    def wrapped(logits, cfg):
        ids, gates, probs = real(logits, cfg)
        seen.append((logits, ids))
        if forced is not None:
            ids = forced(len(seen) - 1, logits)
            gates = torch.softmax(torch.gather(logits, -1, ids), dim=-1)
        return ids, gates, probs

    moe.route_logits = wrapped
    try:
        yield seen
    finally:
        moe.route_logits = real


def decode_vs_forward(model, params, prompts, tok, features, step_logits=None):
    """One decode step of ``tok`` after a prefill of ``prompts`` (B, S)
    against ``forward`` over the prompts plus ``tok``.  Returns the gap and
    forward's last-position logits, in fp32; for each row the number of
    MoE layers where decode's own top-k choices for that token differ from
    forward's; and the largest gap between decode's and forward's router
    logits for that token, over each MoE layer's largest |logit| (None
    without MoE layers).  On a MoE, prefill and decode take forward's
    expert choices: bf16 roundings that differ between the two shapes can
    flip a near-tied choice, which moves a row by a whole expert's share;
    the router logits' gap shows what the choices rest on.  With
    ``step_logits``, that decode step was taken already."""
    n, b = prompts.shape[1], prompts.shape[0]
    toks = torch.cat([torch.as_tensor(prompts, device=tok.device).long(), tok[:, None]], 1)
    with routing() as fwd:
        full, _aux = model.forward(params, model.make_batch(toks, features))
    ref = full[:, -1].float()
    del full
    fwd_ids = [ids.reshape(b, n + 1, -1) for _l, ids in fwd]

    def take(pos):
        return lambda i, logits: fwd_ids[i][:, pos].reshape(*logits.shape[:-1], -1)

    if step_logits is None:
        with routing(take(slice(0, n))):
            _l, cache = model.prefill(params, model.make_batch(prompts, features))
        cache = _grow_cache(model, cache, n + 1, n)
        with routing(take(n)) as dec:
            step_logits, _ = model.decode_step(params, tok, cache, n)
        del cache
    else:
        dec = []
    flips, router_err = [0] * b, None
    for (dec_logits, dec_ids), (fwd_logits, _ids), fwd_id in zip(dec, fwd, fwd_ids):
        d_ids, f_ids = dec_ids.reshape(b, -1), fwd_id[:, n]
        for r in range(b):
            flips[r] += set(d_ids[r].tolist()) != set(f_ids[r].tolist())
        f_logits = fwd_logits.reshape(b, n + 1, -1)[:, n]
        gap = float((dec_logits.reshape(b, -1) - f_logits).abs().max())
        router_err = max(router_err or 0.0, gap / float(f_logits.abs().max()))
    return step_logits.float() - ref, ref, flips, router_err


def lm_phase(
    device: torch.device, cfg, batch: int = LM_BATCH, prompt_len: int = LM_PROMPT,
    steps: int = LM_STEPS, check_batch=None, features=None, then=None,
) -> dict:
    """``LMServer.generate`` on ``model.init`` of ``cfg`` (the enc-dec with
    ``features``); then one prefill and one decode step with their launch
    counts, and the first decode step against ``forward`` over the prompt
    plus its token (on the first ``check_batch`` rows, all by default).  On
    a MoE the check runs prefill, decode and forward again on the same
    weights at the capacity factor E / k, where an expert holds every token
    of its group and nothing can drop (at the config's factor, drops depend
    on the routing group, which differs between the two), with prefill and
    decode taking forward's expert choices (:func:`decode_vs_forward`);
    see below for its two gates.  ``then(model, params)``, when given, runs
    last on the same weights; its result is ``result["then"]``."""
    laps = Laps(device)
    reset_peak(device)
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    model = get_model(cfg)
    params = model.init(torch.Generator(device=gen_device).manual_seed(2), device)
    prompts = np.random.default_rng(2).integers(
        0, cfg.raw_vocab_size, (batch, prompt_len)).astype(np.int32)
    batch_in = model.make_batch(prompts, features)
    server = LMServer(model, params)
    laps.lap("init")
    init_gb = peak_gb(device)
    reset_launch_counts()
    tokens = server.generate(prompts, steps, features=features)
    sync(device)
    launches = launch_counts()
    laps.lap("generate")
    generate_gb = peak_gb(device)
    check(tokens.shape == (batch, steps), f"generated shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token ids out of range")

    reset_launch_counts()
    logits0, cache = model.prefill(params, batch_in)
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
    rows_feat = None if features is None else features[:rows]
    check(bool(torch.isfinite(step_logits).all()), "non-finite decode logits")
    moe = None
    if cfg.family != "moe":
        gap, ref, _flips, _router = decode_vs_forward(
            model, params, prompts[:rows], tok[:rows], rows_feat, step_logits[:rows])
        err, scale = float(gap.abs().max()), float(ref.abs().max())
        check(err <= TF_TOL * scale,
              f"decode vs forward: max abs err {err} > {TF_TOL} x max |logit| {scale}")
    else:
        # Every row's logits at full depth in bf16 within TF_TOL of
        # forward's (the router logits' gap is printed, not held: its bf16
        # noise grows with depth, to 0.10 of a layer's largest |logit| at
        # qwen2-moe's smoke width and 24 layers on the CPU); then in fp32
        # on the first MOE_CHECK_LAYERS layers' weights the logits and
        # each layer's router logits, at the reference's decode tolerance
        # (tests/test_models_equiv.py).  One row at a time: at capacity
        # E / k every expert of mixtral holds all 4609 tokens of a row,
        # about 10 GB of fp32 activations a row.
        no_drop = cfg.moe_num_experts / cfg.moe_top_k
        model_nd = get_model(dataclasses.replace(cfg, moe_capacity_factor=no_drop))
        cfg32 = dataclasses.replace(cfg, num_layers=MOE_CHECK_LAYERS, moe_capacity_factor=no_drop,
                                    dtype="float32", param_dtype="float32")
        moe = {"err_bf16": [], "flipped": [], "router_err_bf16": [],
               "err_fp32": [], "flipped_fp32": [], "router_err_fp32": []}
        scale = 0.0
        for r in range(rows):
            gap, ref, flips, router = decode_vs_forward(
                model_nd, params, prompts[r:r + 1], tok[r:r + 1], None)
            moe["err_bf16"].append(float(gap.abs().max()))
            moe["flipped"] += flips
            moe["router_err_bf16"].append(router)
            scale = max(scale, float(ref.abs().max()))
        err = max(moe["err_bf16"])
        check(err <= TF_TOL * scale,
              f"decode vs forward (decode's own choices flipped in {moe['flipped']} layers): "
              f"max abs err {err} > {TF_TOL} x max |logit| {scale}")
        params32 = {"embed": tree_map(lambda t: t.float(), params["embed"]),
                    "final_norm": tree_map(lambda t: t.float(), params["final_norm"]),
                    "layers": tree_map(lambda t: t[:MOE_CHECK_LAYERS].float(), params["layers"])}
        excess = []
        for r in range(rows):
            gap, ref, flips, router = decode_vs_forward(
                get_model(cfg32), params32, prompts[r:r + 1], tok[r:r + 1], None)
            moe["err_fp32"].append(float(gap.abs().max()))
            moe["flipped_fp32"] += flips
            moe["router_err_fp32"].append(router)
            excess.append(float((gap.abs() - DECODE_FP32_TOL * (1 + ref.abs())).max()))
        del params32
        check(max(excess) <= 0,
              f"fp32 decode vs forward ({MOE_CHECK_LAYERS} layers, decode's own choices "
              f"flipped in {moe['flipped_fp32']}): max abs err {moe['err_fp32']} beyond "
              f"{DECODE_FP32_TOL} abs + rel by {excess}")
        check(max(moe["router_err_fp32"]) <= DECODE_FP32_TOL,
              f"fp32 decode vs forward: router logits differ by {moe['router_err_fp32']} of "
              f"their largest |logit|, > {DECODE_FP32_TOL}")
    del gap, ref
    laps.lap("check")
    result = {"tokens": tokens, "launches": launches, "laps": laps.seconds,
              "prefill_launches": prefill_launches, "decode_launches": decode_launches,
              "decode_vs_forward_err": err, "max_abs_logit": scale, "check_rows": rows,
              "moe_check": moe,
              "init_gb": init_gb, "generate_gb": generate_gb, "mem_gb": peak_gb(device)}
    if then is not None:
        result["then"] = then(model, params)
    if device.type == "cuda":
        result["prefill_ms"] = cuda_ms(lambda: model.prefill(params, batch_in), reps=5, warmup=1)
        result["decode_step_ms"] = cuda_ms(
            lambda: model.decode_step(params, tok, cache, prompt_len), reps=10, warmup=2)
        result["trace"] = {
            "prefill": device_breakdown(lambda: model.prefill(params, batch_in),
                                        result["prefill_ms"]),
            "decode_step": device_breakdown(
                lambda: model.decode_step(params, tok, cache, prompt_len),
                result["decode_step_ms"]),
        }
    return result


def prefill_launches(cfg) -> dict:
    """What one prefill launches: flash once per attention layer (twice per
    enc-dec decoder layer: self and cross), once per shared-attention
    invocation of a hybrid; the SSD once per Mamba2 layer."""
    flash = {"dense": cfg.num_layers, "moe": cfg.num_layers, "vlm": cfg.num_layers,
             "ssm": 0, "hybrid": cfg.num_layers // max(cfg.hybrid_attn_period, 1),
             "encdec": cfg.enc_layers + 2 * cfg.num_layers}[cfg.family]
    ssd = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"pearson_gram": 0, "flash_attention": flash, "ssd_scan": ssd}


def model_lm_phase(device: torch.device, cfg, batch: int, prompt_len: int, steps: int,
                   check_batch: int, label: str, features=None) -> dict:
    """``lm_phase``, checking that a prefill (in ``generate`` and alone)
    launches what :func:`prefill_launches` says and that a decode step
    launches nothing (on the card; every count stays 0 on the CPU, where
    the plain versions run).  Prints a ``label`` JSON line and the trace."""
    res = lm_phase(device, cfg, batch, prompt_len, steps, check_batch=check_batch,
                   features=features)
    expected = prefill_launches(cfg)
    if device.type != "cuda":
        expected = dict.fromkeys(expected, 0)
    for name, got in (("generate", res["launches"]), ("prefill", res["prefill_launches"])):
        check(got == expected, f"{cfg.name} {name}: launches {got}, expected {expected}")
    check(not any(res["decode_launches"].values()),
          f"{cfg.name}: a decode step launched {res['decode_launches']}")
    print(json.dumps({
        label: {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
                "prompt": prompt_len, "steps": steps, "launches": res["launches"],
                "decode_launches": res["decode_launches"],
                "prefill_ms": res.get("prefill_ms"),
                "decode_step_ms": res.get("decode_step_ms"),
                "decode_vs_forward_err": res["decode_vs_forward_err"],
                "max_abs_logit": res["max_abs_logit"], "check_rows": res["check_rows"],
                "moe_check": res["moe_check"],
                "seconds": res["laps"], "peak_memory_gb_init": res["init_gb"],
                "peak_memory_gb_generate": res["generate_gb"],
                "peak_memory_gb": res["mem_gb"], "tokens_row0": res["tokens"][0].tolist()},
    }), flush=True)
    if "trace" in res:
        print(json.dumps({f"{label}_trace": {"arch": cfg.name, **res["trace"]}}), flush=True)
    return res


def ssm_lm_phase(device: torch.device, cfg, batch: int, prompt_len: int, steps: int) -> dict:
    """``model_lm_phase`` on an SSM or hybrid config: a prefill launches the
    SSD kernel once per Mamba2 layer and flash once per shared-attention
    invocation, decode neither."""
    return model_lm_phase(device, cfg, batch, prompt_len, steps, SSM_CHECK_BATCH, "ssm_lm")


def family_lm_phase(device: torch.device, cfg, batch: int, prompt_len: int, steps: int,
                    check_batch: int, frames: int = WHISPER_FRAMES) -> dict:
    """``model_lm_phase`` on a MoE, VLM or enc-dec config; the enc-dec gets
    ``frames`` frames of normals from a seeded generator.  Let the frames
    outnumber the config's ``attn_chunk``: at fewer, the reference's
    ``forward`` pads the cross-attention's keys and its ``prefill`` does
    not, so decode would not match forward (``models/encdec.py``)."""
    features = None
    if cfg.family == "encdec":
        features = np.random.default_rng(3).standard_normal(
            (batch, frames, cfg.enc_inputs)).astype(np.float32)
    return model_lm_phase(device, cfg, batch, prompt_len, steps, check_batch, "family_lm",
                          features)


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


def check_pipeline_launches(tf: dict, cfg, label: str) -> int:
    """A transformer pipeline's launches: flash twice per tapped block of
    each task in the profile (2 layers a block, 3 taps), Pearson once per
    task and branch point, flash once per layer of every block executed in
    ``serve_batch``.  Prints the pipeline's lines; returns the layers per
    block."""
    prof, serve = tf["profile_launches"], tf["serve_launches"]
    layers_per_block = cfg.num_layers // (N_BRANCH_POINTS + 1)
    check(prof["flash_attention"] == layers_per_block * N_TASKS * N_BRANCH_POINTS,
          f"flash kernel launched {prof['flash_attention']} times in the {label} "
          f"profile, expected {layers_per_block * N_TASKS * N_BRANCH_POINTS}")
    check(prof["pearson_gram"] == N_TASKS * N_BRANCH_POINTS,
          f"pearson kernel launched {prof['pearson_gram']} times in the {label} profile")
    check(serve["flash_attention"] == layers_per_block * tf["blocks_executed"],
          f"flash kernel launched {serve['flash_attention']} times in serve_batch, expected "
          f"{layers_per_block} x {tf['blocks_executed']} blocks executed")
    print(f"{label} pipeline: graph {tf['graph']}; flash launches profile "
          f"{prof['flash_attention']}, serve {serve['flash_attention']} "
          f"({tf['blocks_executed']} blocks executed); pearson launches "
          f"{prof['pearson_gram']}; served vs per-block max abs err {tf['max_err']:.3g}",
          flush=True)
    print(json.dumps({f"{label}_pipeline_seconds": tf["laps"],
                      "peak_memory_gb": tf["mem"]}), flush=True)
    for row in tf.get("groups", ()):
        print(json.dumps({f"{label}_group": row}), flush=True)
    if "trace" in tf:
        print(json.dumps({f"{label}_group_trace": tf["trace"]}), flush=True)
    return layers_per_block


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
    # Weight streaming, then journaled sessions through power failures.
    t1 = time.perf_counter()
    lenet_clean = lenet_sessions["window"]
    lenet_stream = streaming_phase(result["engine"], result["requests"],
                                   lenet_clean["responses"], device, "lenet ")
    intermittent_phase(lenet_stream["engine"], result["requests"], lenet_clean, device,
                       PIPELINE_TOL, "lenet ", "file", energy=True)
    print(json.dumps({"lenet_streaming_and_intermittent_seconds": time.perf_counter() - t1}),
          flush=True)
    del result, lenet_sessions, lenet_stream, lenet_clean
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
    layers_per_block = check_pipeline_launches(tf, cfg, "transformer")
    # The same engine and requests through sessions, then scripted faults.
    t0 = time.perf_counter()
    tf_sessions = session_phase(tf["engine"], tf["requests"], device, TF_TOL,
                                f"{ARCH} ", layers_per_block)
    tf_chaos = chaos_phase(tf["engine"], tf["requests"], tf_sessions["window"]["responses"],
                           device, TF_TOL, f"{ARCH} ")
    print(json.dumps({"transformer_session_seconds": time.perf_counter() - t0}), flush=True)
    session_flash = {name: v["row"]["launches"]["flash_attention"]
                     for name, v in tf_sessions.items()}
    # Weight streaming on the same program, then journaled sessions through
    # power failures, with and without checkpoints.
    t0 = time.perf_counter()
    tf_clean = tf_sessions["window"]
    tf_stream = streaming_phase(tf["engine"], tf["requests"], tf_clean["responses"], device,
                                f"{ARCH} ", layers_per_block)
    tf_inter = intermittent_phase(tf_stream["engine"], tf["requests"], tf_clean, device, TF_TOL,
                                  f"{ARCH} ", "memory", layers_per_block)
    stream_flash = {
        "transformer_streaming": tf_stream["row"]["launches"]["flash_attention"],
        **{f"transformer_intermittent_{arm}": row["launches"]["flash_attention"]
           for arm, row in tf_inter.items()}}
    print(json.dumps({"transformer_streaming_and_intermittent_seconds":
                      time.perf_counter() - t0}), flush=True)
    del tf, tf_sessions, tf_stream, tf_clean
    free_memory()

    # mistral-nemo-12b, 8 layers: LMServer prefill + greedy decode, then the
    # continuous batcher on the same weights.
    lm = lm_phase(device, cfg, then=lambda model, params: batcher_phase(device, model, params,
                                                                        cfg))
    batcher_flash = lm["then"]["launches"]["flash_attention"]
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
    print(json.dumps({"seconds_to_the_new_families": time.perf_counter() - t_start}), flush=True)

    # qwen2-moe-a2.7b, 8 layers: profile -> select -> order -> serve.
    t0 = time.perf_counter()
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    moe = transformer_pipeline_phase(device, moe_cfg, label="moe")
    check_pipeline_launches(moe, moe_cfg, "moe")
    moe_prof, moe_serve = moe["profile_launches"], moe["serve_launches"]
    del moe
    free_memory()
    print(json.dumps({"moe_pipeline_phase_seconds": time.perf_counter() - t0}), flush=True)

    # The MoE, VLM and enc-dec families: LMServer prefill + greedy decode,
    # then the serve launcher on whisper-medium at its full config.
    family = {}
    for arch, layers, batch, prompt, steps, rows in FAMILY_LMS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        family[arch] = family_lm_phase(device, cfg, batch, prompt, steps, rows)
        del family[arch]["trace"]
        free_memory()
        print(json.dumps({"family_lm_phase_seconds": {arch: time.perf_counter() - t0}}),
              flush=True)
    whisper = get_config("whisper-medium")
    launcher_whisper = launcher_phase("whisper-medium")
    check(launcher_whisper["launches"] == prefill_launches(whisper),
          f"whisper launcher: launches {launcher_whisper['launches']}")
    print(json.dumps({"launcher": launcher_whisper}), flush=True)
    free_memory()
    print(json.dumps({"smoke_seconds": time.perf_counter() - t_start}), flush=True)

    pearson_row = kernels["rows"][0]
    transformer_pearson_row = next(r for r in kernels["rows"] if r["K"] == TF_PROBES)
    moe_pearson_row = next(r for r in kernels["rows"]
                           if (r["K"], r["F"]) == (TF_PROBES, TF_SEQ * moe_cfg.d_model))
    family_flash = {f"{arch}_prefill": family[arch]["launches"]["flash_attention"]
                    for arch in family}
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
                     + qs_row["launches"]["pearson_gram"] + moe_prof["pearson_gram"]),
        "launches_by_path": {"lenet_profile": lenet_launches["pearson_gram"],
                             "transformer_profile": prof["pearson_gram"],
                             "quickstart_profile": qs_row["launches"]["pearson_gram"],
                             "moe_profile": moe_prof["pearson_gram"]},
        "max_abs_err": kernels["max_abs_err"],
        "ms": pearson_row["kernel_ms"],
        "plain_ms": pearson_row["plain_ms"],
        "bound_ms": pearson_row["bound_ms"],
        "bound_by": pearson_row["bound_by"],
        "library_ms": pearson_row["library_ms"],
        "shape": [pearson_row["K"], pearson_row["F"]],
        "by_path": {path: {"shape": [r["K"], r["F"]], **{k: r[k] for k in timed}}
                    for path, r in (("lenet_profile", pearson_row),
                                    ("transformer_profile", transformer_pearson_row),
                                    ("moe_profile", moe_pearson_row))},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:113",
        "launches": (prof["flash_attention"] + serve["flash_attention"]
                     + sum(session_flash.values())
                     + tf_chaos["launches"]["flash_attention"]
                     + sum(stream_flash.values()) + batcher_flash
                     + lm["launches"]["flash_attention"] + zamba["launches"]["flash_attention"]
                     + moe_prof["flash_attention"] + moe_serve["flash_attention"]
                     + sum(family_flash.values())
                     + launcher_whisper["launches"]["flash_attention"]),
        "launches_by_path": {"transformer_profile": prof["flash_attention"],
                             "transformer_serve": serve["flash_attention"],
                             **{f"transformer_session_{name}": n
                                for name, n in session_flash.items()},
                             "transformer_session_chaos": tf_chaos["launches"]["flash_attention"],
                             **stream_flash,
                             "batcher_prefill": batcher_flash,
                             "lm_prefill": lm["launches"]["flash_attention"],
                             "zamba2_prefill": zamba["launches"]["flash_attention"],
                             "moe_profile": moe_prof["flash_attention"],
                             "moe_serve": moe_serve["flash_attention"],
                             **family_flash,
                             "whisper_launcher": launcher_whisper["launches"]["flash_attention"]},
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
