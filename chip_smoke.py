"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernel (the Pearson Gram) from the sources in
   this checkout and holds it against its plain PyTorch version on the card,
   at the main path's shapes and a few ragged ones, in fp32 and from bf16
   inputs, timing kernel, plain version and one library call with CUDA
   events.
2. Drives Antler's main path on the card at the full width of the paper's
   LeNet-5: affinity profiling of 5 random-initialised per-task networks on
   512 probes, task-graph selection, Held-Karp and GA ordering, then
   ``MultitaskEngine.serve_batch`` on 48 requests over several task subsets.
   It checks the Pearson kernel ran 15 times, the served counters equal the
   cost model's prediction field for field, the outputs match the per-block
   executor, and Antler's counters beat Vanilla's.
3. Prints one ``{"kernels": [...]}`` line, then the device line last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  TF32 is switched off for matmuls and cuDNN:
the checks hold fp32 to 1e-5.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    MSP430, GAConfig, GraphCostModel, TaskGraph, TaskGraphExecutor,
    VanillaExecutor, genetic_order, optimal_order,
)
from repro_torch.core.affinity import affinity_matrix, profile_task  # noqa: E402
from repro_torch.core.tradeoff import select_task_graph  # noqa: E402
from repro_torch.data import MultitaskDataset, train_test_split  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.pearson_affinity import (  # noqa: E402
    SOURCE as PEARSON_SOURCE, pearson_dissimilarity,
)
from repro_torch.kernels.ref import pearson_dissimilarity_ref  # noqa: E402
from repro_torch.models.cnn import build_lenet5_blocks  # noqa: E402
from repro_torch.models.multitask import build_cnn_program  # noqa: E402
from repro_torch.serving import MultitaskEngine, MultitaskRequest  # noqa: E402

N_TASKS, N_CLASSES, N_BRANCH_POINTS = 5, 4, 3
N_PROBES = 512
N_REQUESTS = 48
SUBSETS = (None, (0, 1), (2, 3, 4), (1, 3), (4,))
# (K, F): the main path's three branch points at K = 512, then ragged edges.
PEARSON_SHAPES = ((512, 1568), (512, 784), (512, 64), (37, 100), (64, 300))
FP32_TOL, BF16_TOL, PIPELINE_TOL = 1e-5, 5e-2, 1e-5
# Published H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM3.
FP32_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """Least time on the card: 2*K*K*F fp32 FLOPs vs K*F + K*K fp32 bytes."""
    ops_ms = 2.0 * k * k * f / FP32_PEAK_FLOPS * 1e3
    bytes_ms = 4.0 * (k * f + k * k) / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
    }


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
        plain = pearson_dissimilarity_ref(z)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        check(err <= FP32_TOL, f"pearson fp32 {k}x{f}: max abs err {err} > {FP32_TOL}")
        check(torch.equal(out, out.T), f"pearson fp32 {k}x{f}: output not symmetric")

        fb = feats.to(torch.bfloat16)
        out_bf = ops.pairwise_pearson_dissimilarity(fb)
        plain_bf = pearson_dissimilarity_ref(ops.standardize_rows(fb))
        torch.cuda.synchronize()
        err_bf = float((out_bf - plain_bf).abs().max())
        check(err_bf <= BF16_TOL, f"pearson bf16 {k}x{f}: max abs err {err_bf} > {BF16_TOL}")

        one = torch.ones((), device=device)
        row = {
            "kernel": "pearson_gram", "K": k, "F": f,
            "max_abs_err": err, "max_abs_err_bf16": err_bf,
            "kernel_ms": cuda_ms(lambda: pearson_dissimilarity(z)),
            "plain_ms": cuda_ms(lambda: pearson_dissimilarity_ref(z)),
            # One library call computing 1 - Z Z^T: the yardstick only.
            "library_ms": cuda_ms(lambda: torch.addmm(one, z, z.T, alpha=-1.0)),
            **pearson_bound(k, f),
            "peak": "fp32 CUDA cores 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {
        "rows": rows,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
    }


def branch_point_taps(program, task: int, x: torch.Tensor):
    """Representations at the branch points (after blocks 0..D-1) of one
    task's path, flattened per sample — the quickstart's profiling taps."""
    taps, h = [], x
    for d, node in enumerate(program.graph.path(task)):
        if d == N_BRANCH_POINTS:
            break
        h = program.block_fns[d](program.node_params[node], h)
        taps.append(h.reshape(h.shape[0], -1))
    return taps


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
    check(aff.shape == (N_BRANCH_POINTS, N_TASKS, N_TASKS), f"affinity shape {aff.shape}")
    check(bool(np.isfinite(aff).all()), "affinity has non-finite entries")
    check(np.allclose(np.diagonal(aff, axis1=1, axis2=2), 1.0, atol=1e-5),
          "affinity diagonal is not 1")

    # Task-graph selection and ordering.
    sel = select_task_graph(N_TASKS, N_BRANCH_POINTS, aff, costs, MSP430).selected
    laps.lap("select")
    cm = GraphCostModel(sel.graph, costs, MSP430)
    exact = optimal_order(cm.cost_matrix())
    ga = genetic_order(cm.cost_matrix(), config=GAConfig(seed=0))
    laps.lap("order")
    check(ga.cost >= exact.cost - 1e-12, "GA beat the exact solver")
    print(f"selected graph {sel.graph.partitions}; exact order {exact.order} "
          f"cost {exact.cost * 1e3:.3f} ms (modelled, MSP430); GA order "
          f"{ga.order} cost {ga.cost * 1e3:.3f} ms", flush=True)

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
    check(engine.last_batch_stats == predicted,
          f"served counters {engine.last_batch_stats} != predicted {predicted}")
    check(len({engine.normalized_subset(SUBSETS[s]) for s in picks}) >= 4,
          "fewer than 4 task subsets requested")

    reference = TaskGraphExecutor(prog2, fused=False)
    max_err = 0.0
    for group in plan:
        outs, _stats = reference.run_batch(
            group.xs.to(device), engine.group_order(group), valid=group.valid
        )
        for slot, i in enumerate(group.indices):
            got = responses[i].outputs
            check(set(got) == set(engine.group_order(group)), f"request {i} tasks")
            for t, y in got.items():
                check(tuple(y.shape) == (1, N_CLASSES), f"output shape {tuple(y.shape)}")
                check(bool(torch.isfinite(y).all()), "non-finite output")
                max_err = max(max_err, float((y - outs[t][slot]).abs().max()))
    check(max_err <= PIPELINE_TOL, f"served vs per-block max abs err {max_err}")

    # Antler's block cache against the Vanilla baseline (quickstart step 5).
    x = torch.as_tensor(xte[:8], device=device)
    _o, s_ant = TaskGraphExecutor(prog2).run(x, list(exact.order))
    _o, s_van = VanillaExecutor(prog2).run(x, list(exact.order))
    print(f"antler : {s_ant.blocks_executed} blocks executed, "
          f"{s_ant.blocks_skipped} skipped, {s_ant.seconds(MSP430) * 1e3:.2f} ms modelled (MSP430)")
    print(f"vanilla: {s_van.blocks_executed} blocks executed, "
          f"{s_van.blocks_skipped} skipped, {s_van.seconds(MSP430) * 1e3:.2f} ms modelled (MSP430)",
          flush=True)
    check(s_van.seconds(MSP430) > s_ant.seconds(MSP430), "Vanilla not slower than Antler")
    check(s_van.blocks_executed > s_ant.blocks_executed, "Vanilla executed no more blocks")
    return {
        "engine": engine, "plan": plan, "requests": requests,
        "laps": laps.seconds, "max_err": max_err,
    }


def time_groups(result: dict) -> list:
    """Per-group wall time of the engine's group execution (CUDA events),
    after the checked run, on a warm engine."""
    engine = result["engine"]
    out = []
    for group in result["plan"]:
        ms = cuda_ms(lambda: engine._execute_group(group), reps=20, warmup=2)
        out.append({"tasks": sorted(group.tasks) if group.tasks else "all",
                    "valid": group.valid, "padded": int(group.xs.shape[0]),
                    "order": list(engine.group_order(group)), "ms": ms})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    t0 = time.perf_counter()
    _build.build(PEARSON_SOURCE)
    print(f"built {PEARSON_SOURCE} in {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = kernel_phase(device)

    pearson_dissimilarity.launches = 0
    result = pipeline_phase(device)
    launches = pearson_dissimilarity.launches
    check(launches == N_TASKS * N_BRANCH_POINTS,
          f"pearson kernel launched {launches} times on the main path, "
          f"expected {N_TASKS * N_BRANCH_POINTS}")
    print(f"pipeline: pearson launches {launches}; serve_batch "
          f"{len(result['requests'])} requests in {len(result['plan'])} groups; "
          f"served vs per-block max abs err {result['max_err']:.3g}", flush=True)
    print(json.dumps({"pipeline_seconds": result["laps"]}), flush=True)
    for row in time_groups(result):
        print(json.dumps({"group": row}), flush=True)

    main_row = kernels["rows"][0]
    print(json.dumps({"kernels": [{
        "name": "pearson_gram",
        "route": "cuda",
        "source": "src/repro_torch/csrc/pearson_gram.cu",
        "replaces": "src/repro/kernels/pearson_affinity.py:71",
        "launches": launches,
        "max_abs_err": kernels["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [main_row["K"], main_row["F"]],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
