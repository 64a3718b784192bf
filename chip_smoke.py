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
   must move and its scratch bytes.  The flash backward (three kernels
   behind ``FlashAttentionFunction``; bf16 on the tensor cores, each
   kernel's device time from one profiler window) is held against the plain backward on
   the forward's own output and logsumexp and against autograd through the
   plain forward, in fp32 and bf16, at mistral's training shape, 1000
   frames over 1024 zero-padded keys without the causal mask, a causal
   window the sequence passes, and head_dim 80 and 128; two backward calls
   give the same bits, and the forward without the logsumexp (inference)
   the same bits as with it; SDPA's backward is its yardstick.  The SSD
   backward (behind ``SSDScanFunction``: eight CUDA-core kernels in fp32,
   seven in bf16 with the chunk, dkey and dquery kernels on the tensor
   cores; each kernel's device time and the call's scratch bytes) is held
   against the plain backward ``ssd_scan_bwd_ref`` at mamba2-780m's and
   zamba2-2.7b's training shapes in fp32 and bf16 and at a ragged length
   with a final-state cotangent; two calls give the same bits, and under
   autograd the forward gives the inference forward's bits and the
   gradients the backward kernels'.
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
   ones included (the journal in a ``MemoryJournalStore``), and
   input-adaptive sessions on ``EnginePolicy(adaptive=AdaptivePolicy(...))``
   engines sharing the program (``adaptive_phase``): the all-blocks floor
   (``threshold=inf``), the median block-1 confidence as threshold in both
   gate modes and on the unfused rung, three thresholds in a row, an
   online-calibrated re-serve, a two-rung deadline ladder, a journaled
   session through a ``"suffix"`` power failure, and LeNet-5's engine at
   the same policy.
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
9. Trains mistral-nemo-12b at full width, 8 of its 40 layers, remat on:
   one batch of 4 x 512 tokens from ``lm_batches`` through the kernels and
   through the plain attention on the same card from the same params
   (loss and grad norm within 2e-2, each attention weight's gradient
   within 5e-2 of its largest |value|), with ``grad_accum=2`` (loss within
   2e-2), then 6 AdamW steps through ``make_train_step`` (the loss falls;
   step ms, tokens/s, model FLOPs over the bf16 peak, peak memory, busy
   share and top kernels), and a checkpoint round trip (bit-exact).  Then
   the train launcher (``repro_torch.launch.train``) in-process on
   whisper-medium's full config, 3 steps of 4 x 128 (its encoder and
   cross-attention run the backward over keys zero-padded to 1024).
10. Trains mamba2-780m (48 layers, 4 x 2048) and zamba2-2.7b (54 layers,
   4 x 1024) at full width and depth, remat on: the first batch through
   the kernels and through the plain SSD and attention (loss and grad norm
   within 2e-2; each Mamba2 leaf's gradient, all of which pass through the
   SSD backward, nonzero and within 5e-2 of its largest |value|), then 6
   AdamW steps (the loss falls; step ms, tokens/s, peak memory, busy share
   and top kernels); then the train launcher on mamba2-780m (3 steps of 4
   x 512).  Then the two examples: ``repro_torch.examples.train_multitask``
   at its reference size (the ~100M granite-family backbone, 10 task-graph
   nodes, 40 AdamW steps of 16 x 128: the loss falls; step ms, tokens/s)
   and ``repro_torch.examples.serve_multitask`` whole (Antler beats
   Vanilla, counters equal the prediction, the LM generates its tokens);
   and Pearson's guard: under grad on the card it raises.  Then the launch
   analysis (``dryrun_phase``): ``python -m repro_torch.launch.dryrun`` on
   mistral-nemo-12b ``train_4k``, mixtral-8x22b ``prefill_32k`` and
   mamba2-780m ``train_4k`` at full width and depth, on meta tensors in a
   fake world of 256 ranks (a 16 x 16 mesh), one subprocess each (status
   ok, FLOPs, bytes and collective bytes positive, model FLOPs the
   estimate's, each kernel counted as often as the step launches it, and
   the FLOPs of the 256 ranks at most 1.10 times the same plan counted in a
   world of one: each rank does only its share); and
   one more step of the mistral (8 layers) and mamba2 training above counted
   by ``analyze_step`` on the card and on meta (equal FLOPs, bytes within
   2 %, each launch counted once by its formula, ``roofline_share`` of the
   steady step at most 1.05; ``mfu``, the counted FLOPs' share and the peak
   bytes beside ``max_memory_allocated``), printed on the ``dryrun`` line
   with the card's name and power limit.
11. Serves the LeNet-5 and mistral-nemo-12b traces of steps 3 and 4 again,
   from programs rebuilt from the same seeds, through sessions on
   mesh-sharded engines (``EnginePolicy(mesh=..., sharding=...)``): a world
   of one rank (NCCL), a (1, 1) ("data", "model") ``DeviceMesh``, under
   ``TP_POLICY`` and ``FSDP_TP_POLICY``, against the same trace off the
   mesh; then once more under a scripted "dispatch" fault whose group the
   ladder's "single_device" rung serves off the mesh.  One device issues no
   collective: outputs within the paths' tolerances of the off-mesh
   session's, counters equal to the prediction with 0 collective bytes,
   flash launched as often as off the mesh (on each rank's local heads).
   Prints a ``mesh`` line per engine and policy (group ms and session
   seconds on and off the mesh, host ms per dispatch, busy share, top
   device operations), then destroys the process group.
12. LM serving and training on a (1, 1) mesh (``lm_mesh_phase``; a world
   of one rank, NCCL, made and ended by ``launch.mesh.launcher_world``),
   each run off the mesh and then on it from the same params, placed by
   ``fit_specs(params, model.param_specs(policy), mesh)``:
   ``LMServer.generate`` on mistral-nemo-12b (full width, 8 layers, bf16,
   4 x 512, 16 steps) under TP and FSDP_TP, on qwen2-moe-a2.7b (full, 4 x
   512, 8 steps) under EXPERT_TP and FSDP_EXPERT and on mamba2-780m
   (full, 4 x 2048, 8 steps; the SSD on local heads) under TP; 3 AdamW
   steps of mistral-nemo-12b (8 layers, 4 x 512, remat) under FSDP_TP and
   2 of mamba2-780m (4 x 2048) under TP.  Gates: the same tokens, prefill
   logits within 5e-2 of the largest |logit|, losses and grad norms
   within 2e-2, the same flash and SSD launches forward and backward, no
   collective bytes.  Prints an ``lm_mesh`` line a run (prefill and
   decode ms, host ms a decode step, tokens/s, busy share, step ms and
   peak GB, on and off the mesh, beside the card's name and power limit).
   Then a sharded mesh with values on the host's torch (``gloo_mesh_phase``):
   8 gloo ranks on the CPU, one subprocess each, on a (2, 4) ("data",
   "model") mesh, where mistral's and granite-34b's query heads split over
   ranks that share a KV head: a smoke mistral-nemo-12b and a smoke
   mamba2-780m train step (loss and every gradient leaf) and a smoke
   granite-34b prefill (logits) against the same code off the mesh; prints
   the ``gloo_mesh`` line.
13. Prints one ``{"kernels": [...]}`` line, then the device line last.

Each path runs with every launch count set to 0 just before it and read
just after; the script checks that the kernels ran where the path runs
them (Pearson 15 times per profile, the quickstart's included; flash
attention 30 times in each transformer profile, twice per executed block
in serving and in every session — a journaled one's lost work included,
a mesh session's as often as off the mesh —,
once per decoder layer of a prefill and of each batcher wave's prefill (8,
24, 8, 48), 9 times in zamba2's, 72 times in whisper's (once per encoder
layer, twice per decoder layer); the SSD once per Mamba2 layer of a
prefill, 48 and 54; none in decode; in training, flash twice per
attention layer of a step, forward and remat, and its backward once; the
SSD twice per Mamba2 layer of a step and its backward once, zamba2's
shared attention once forward and once backward per invocation; the
multitask example's flash and its backward once per layer of each of its
10 nodes, 20 a step; on the LM mesh as often as off it),
that served counters equal the cost
model's prediction field for field (every session's too, faults,
streamed loads, checkpoint writes and a one-device mesh's 0 collective
bytes included), that served outputs match
the per-block executor, that every session request succeeds, that faulted
outputs match the fault-free session's, that streamed outputs are
bit-identical to the synchronous session's, that journaled sessions answer
every request exactly once through their power failures, resume an
interrupted group from its checkpoint depth and restore journaled
activations bit-exactly, that the adaptive floor's outputs are
bit-identical to the non-adaptive session's and every adaptive session
launches flash as often as the floor (masking computes every row), that
gated sessions gate rows with counters equal to the prediction, the two
gate modes and the unfused rung agreeing on every gate trace, that a
threshold change builds no new suffix program, that the calibrated
expected flops come within 5 % of the realized, that each ladder group
runs at its worst slack's rung, that nothing is gated on LeNet-5 (its
blocks change shape), that each batcher request's tokens equal
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
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.adaptive import AdaptivePolicy, mean_abs_confidence  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MSP430, TPU_V5E, GAConfig, GraphCostModel, TaskGraph, TaskGraphExecutor,
    VanillaExecutor, genetic_order, optimal_order,
)
from repro_torch.core.affinity import affinity_matrix, profile_task  # noqa: E402
from repro_torch.core.tradeoff import select_task_graph  # noqa: E402
from repro_torch.data import MultitaskDataset, train_test_split  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_multitask as serve_example  # noqa: E402
from repro_torch.examples import train_multitask as train_example  # noqa: E402
from repro_torch.examples.quickstart import branch_point_taps  # noqa: E402
from repro_torch._device import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_module  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    SOURCE as FLASH_SOURCE, flash_attention,
)
from repro_torch.kernels.pearson_affinity import (  # noqa: E402
    SOURCE as PEARSON_SOURCE, pearson_dissimilarity,
)
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_bhsd_bwd_ref, flash_attention_bhsd_ref, flash_attention_ref,
    pearson_dissimilarity_ref, ssd_scan_bwd_ref, ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SOURCE as SSD_SOURCE, PlainSSDFunction,
    backward_scratch_bytes as ssd_backward_scratch_bytes, kernel_bytes as ssd_kernel_bytes,
    scratch_bytes as ssd_scratch_bytes, ssd_scan, ssd_scan_backward,
)
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.op_cost import analyze_step  # noqa: E402
from repro_torch.launch.specs import opt_shapes, param_shapes  # noqa: E402
from repro_torch.models.config import InputShape, get_shape  # noqa: E402
from repro_torch.models.cnn import build_lenet5_blocks  # noqa: E402
from repro_torch.models.multitask import (  # noqa: E402
    _split_layers, build_cnn_program, build_transformer_program, multitask_loss,
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
from repro_torch.serving.engine import _grow_cache, greedy  # noqa: E402
from repro_torch.sharding.collectives import CollectiveRecorder  # noqa: E402
from repro_torch.sharding.utils import is_dtensor  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig, AdamWState, adamw_init, global_norm, loss_and_grads, make_train_step,
    restore_checkpoint, save_checkpoint,
)

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
# The flash backward's rows, model layout: (path, B, S, T, Hq, Hk, d, causal,
# window, real keys), each in fp32 and bf16.  mistral-nemo-12b's train step;
# 1000 frames over 1024 keys zero-padded past them, non-causal (as the
# whisper encoder's chunked attention pads them); a causal window the
# sequence passes; head_dim 80 (zamba2's attention) and 128 (qwen2-moe's).
FLASH_BWD = (
    ("train", 4, 512, 512, 32, 8, 160, True, None, None),
    ("whisper_padded", 4, 1000, 1024, 16, 16, 64, False, None, 1000),
    ("window", 2, 1024, 1024, 8, 2, 128, True, 256, None),
    ("d80", 4, 1024, 1024, 32, 32, 80, True, None, None),
    ("d128", 4, 512, 512, 16, 16, 128, True, None, None),
)
# Each gradient's max abs error over its largest |value|: fp32 sums in
# another order; bf16 inputs, each gradient rounded to bf16 once (the
# measured worst is ~4.5e-3 against autograd through the plain version).
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# The training path: mistral-nemo-12b at full width, depth 40 -> 8, with
# remat, B x S tokens from lm_batches, TRAIN_STEPS AdamW steps.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4, 512, 6
TRAIN_LOSS_TOL = 2e-2   # kernel route vs plain route, relative: loss, grad norm, grad_accum 2
TRAIN_GRAD_TOL = 5e-2   # an attention weight's grad, of its largest |value|
TRAIN_LAUNCHER = ("whisper-medium", 3, 4, 128)  # arch, steps, batch, seq

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
# The SSD backward's rows (path, B, S, H, P, N, chunk, dtype, with a
# cotangent of the final state): mamba2-780m's and zamba2-2.7b's training
# shapes (the models discard the final state), then a ragged length with a
# nonzero final-state cotangent at mamba2's widths (bf16) and at four heads
# (fp32).  x, B and C are views of one conv output, as in the model.
SSD_BWD = (
    ("mamba2_train", 4, 2048, 48, 64, 128, 64, torch.bfloat16, False),
    ("mamba2_train", 4, 2048, 48, 64, 128, 64, torch.float32, False),
    ("zamba2_train", 4, 1024, 80, 64, 64, 256, torch.bfloat16, False),
    ("zamba2_train", 4, 1024, 80, 64, 64, 256, torch.float32, False),
    ("ragged_final", 2, 200, 48, 64, 128, 64, torch.bfloat16, True),
    ("ragged_final", 2, 200, 4, 64, 128, 64, torch.float32, True),
)
# Each gradient's max abs error over its largest |value|: fp32 sums in
# other orders; bf16 inputs widened, dx, dB and dC rounded to bf16 once.
SSD_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# SSM training at full width and depth, remat on: (arch, batch, seq, steps).
TRAIN_SSMS = (("mamba2-780m", 4, 2048, 6), ("zamba2-2.7b", 4, 1024, 6))
# Each leaf's gradient, kernel vs plain route, is gated on an fp32 copy of
# the config at full width cut to a few layers (a multiple of the hybrid's
# attention period), where bf16 roundings do not compound over the depth:
# within 1e-3 of its largest |value| (fp32 sums in other orders through
# the layers; the kernels alone agree to 2e-4).  At full depth in bf16 the
# routes' Mamba2 gradients differ by 4-8 % of their largest |value| on an
# H100 (PERF.md, section 6): printed, not gated.
SSM_FP32_CHECK_LAYERS = {"ssm": 2, "hybrid": 6}
SSM_FP32_GRAD_TOL = 1e-3
TRAIN_SSM_LAUNCHER = ("mamba2-780m", 3, 4, 512)  # arch, steps, batch, seq
# The multitask training example at its reference size: steps, batch, seq.
TRAIN_MULTITASK = (40, 16, 128)
# The launch analysis (dryrun_phase): the dry run of three full configs on
# the 16 x 16 production mesh of a fake 256-rank world, one subprocess each,
# started together; and the train steps counted on the card and on meta.
# (arch, shape, policy): mixtral's prefill under FSDP, which the 80 GB
# budget's automatic choice (tp) would not exercise.
DRYRUN_CASES = (("mistral-nemo-12b", "train_4k", "auto"),
                ("mixtral-8x22b", "prefill_32k", "fsdp_tp"),
                ("mamba2-780m", "train_4k", "auto"))
DRYRUN_SECONDS = 240
# Each rank does its share: a dry run's FLOPs over the 256 ranks at most this
# many times the same plan's counted in a world of one.
DRYRUN_FLOPS_SLACK = 1.10
DRYRUN_COUNTED_SSM = "mamba2-780m"  # train_ssm_phase counts this arch's step
COUNT_BYTES_TOL = 0.02     # a step's counted bytes, card vs meta, relative
ROOFLINE_SHARE_MAX = 1.05  # no count may make the card look faster than its peak


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
    """Least time on the card of ``roofline.pearson_work``: K*(K+1)*F fp32
    FLOPs (the upper triangle of the symmetric Z Z^T, diagonal included) vs
    K*F + K*K fp32 bytes.  Also the bound of the full product, 2*K*K*F
    FLOPs, which earlier runs used."""
    work = roofline.pearson_work(k, f)
    full = roofline.bound({"flops": 2.0 * k * k * f, "bytes": work["bytes"]}, torch.float32)
    return {**roofline.bound(work, torch.float32), "bound_ms_full_product": full["bound_ms"]}


def launch_counts() -> dict:
    return {"pearson_gram": pearson_dissimilarity.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.backward_launches,
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_bwd": ssd_scan.backward_launches}


def reset_launch_counts() -> None:
    pearson_dissimilarity.launches = 0
    flash_attention.launches = 0
    flash_attention.backward_launches = 0
    ssd_scan.launches = 0
    ssd_scan.backward_launches = 0


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
# Input-adaptive gating
# --------------------------------------------------------------------------

# The adaptive sessions run the window policy's trace.  The ladder's rungs:
# a group whose worst deadline slack is at least ADAPTIVE_RUNGS[i][0]
# seconds runs at ADAPTIVE_RUNGS[i][1] times the base threshold (lower: more
# rows exit).  In ``serve_session`` a request's slack is DEADLINE_IN when its
# burst is admitted at once and DEADLINE_IN - BURST_DT after one more burst.
ADAPTIVE_RUNGS = ((0.0, 0.99), (DEADLINE_IN - BURST_DT / 2, 0.97))
# Power failure of the journaled adaptive session (invocation index).
ADAPTIVE_POWER_SCRIPT = {"suffix": (1,)}
# The calibrated re-serve's expected flops within this share of the realized.
CALIBRATION_TOL = 0.05


def adaptive_engine(engine, **adaptive) -> MultitaskEngine:
    """An ``EnginePolicy(adaptive=AdaptivePolicy(**adaptive))`` engine sharing
    ``engine``'s program, hardware model and task order."""
    return MultitaskEngine(engine.program, hw=engine.hw, order=engine.order,
                           policy=EnginePolicy(adaptive=AdaptivePolicy(**adaptive)))


def adaptive_session(engine, requests, policy=None) -> dict:
    """``serve_session`` (the window policy by default) on an adaptive
    engine, with each executed group's gate trace, the threshold the gater
    ran it at, the fire-mask readbacks and their host seconds, and the
    kernels' launches."""
    policy = policy if policy is not None else SESSION_POLICIES[STREAM_POLICY]
    groups = []
    execute = engine._execute_group

    def recorded(group, *args, **kw):
        execution = execute(group, *args, **kw)
        groups.append({"trace": execution.gate_trace, "asked": kw.get("adaptive_threshold"),
                       "threshold": engine.executor.gater.threshold})
        return execution

    ex = engine.executor
    readbacks, readback_s = ex.gate_readbacks, ex.gate_readback_seconds
    engine._execute_group = recorded
    reset_launch_counts()
    try:
        session, responses, by_request, planned, seconds, _busy = serve_session(
            engine, requests, policy)
    finally:
        del engine._execute_group
    out = {"session": session, "responses": responses, "by_request": by_request,
           "planned": planned, "seconds": seconds, "groups": groups,
           "launches": launch_counts(), "readbacks": ex.gate_readbacks - readbacks,
           "readback_seconds": ex.gate_readback_seconds - readback_s}
    check(session.stats == session.predicted,
          f"adaptive session counters {session.stats} != predicted {session.predicted}")
    return out


def timed_sessions(engines: dict, requests, reps: int = 3) -> dict:
    """Warm drain seconds of each engine's window session, taken in turns
    (a, b, c, c, b, a, a, b, c for ``reps`` 3) so a drifting host weighs on each
    alike; on the card also each one's device ms over one profiled session
    and its busy share against the mean drain."""
    policy = SESSION_POLICIES[STREAM_POLICY]
    names = list(engines)
    seconds = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            seconds[name].append(serve_session(engines[name], requests, policy)[4])
    out = {}
    for name, engine in engines.items():
        row = {"drain_seconds": seconds[name], "mean_seconds": float(np.mean(seconds[name]))}
        if engine.device.type == "cuda":
            trace = device_breakdown(lambda: serve_session(engine, requests, policy),
                                     row["mean_seconds"] * 1e3, warm=False, cpu=False)
            check(trace["device_ms"] > 0, f"{name}: the profiler saw no device time")
            row.update(busy=trace["busy"], device_ms=trace["device_ms"])
        out[name] = row
    return out


def block1_threshold(engine, requests) -> float:
    """The median, over ``requests``, of the confidence of block 1's input in
    one ungated pass: block 0 of the path of the first task each request's
    group runs, on that request alone."""
    program, graph = engine.program, engine.program.graph
    xs = torch.as_tensor(np.stack([np.asarray(r.x) for r in requests]), device=engine.device)
    first = [next(t for t in engine.order if r.tasks is None or t in r.tasks) for r in requests]
    conf = torch.empty(len(requests), dtype=torch.float32, device=engine.device)
    block0 = engine.executor._block_fn(0, batched=True)
    for node in {graph.path(t)[0] for t in first}:
        rows = [i for i, t in enumerate(first) if graph.path(t)[0] == node]
        h = block0(program.node_params[node], xs[rows])
        conf[rows] = torch.vmap(mean_abs_confidence)(h).float()
    return float(conf.median())


def same_outputs(got, want, label: str, tol=None) -> float:
    """Outputs of two response lists: ``torch.equal`` (``tol`` None) or
    within ``tol``; returns the max abs difference."""
    err = 0.0
    for g, w in zip(got, want):
        check(set(g.outputs) == set(w.outputs), f"{label}: tasks differ")
        for t, y in g.outputs.items():
            d = float((y.float() - w.outputs[t].float()).abs().max())
            err = max(err, d)
            check(torch.equal(y, w.outputs[t]) if tol is None else d <= tol,
                  f"{label}: output of task {t} differs (max abs {d})")
    return err


def adaptive_phase(engine, requests, clean, lenet, device, tol: float, label: str,
                   layers_per_block=None) -> dict:
    """Input-adaptive gating on engines sharing ``engine``'s program, over the
    window policy's trace (``clean`` is that trace's non-adaptive session:
    its responses and row).  Gates, in order:

    1. the all-blocks floor, ``threshold=inf``: outputs bit-identical to the
       non-adaptive session's, no row gated, the same flash launches;
    2. at the median block-1 confidence, in both modes: counters equal the
       prediction, rows gated, fewer modelled flops than the floor, flash
       launches equal to the floor's (masking computes every row), the two
       modes' gate traces equal, the unfused rung's trace equal to the
       fused one's and its outputs within ``tol``; on LeNet-5 (``lenet``:
       its engine, requests and clean window responses) nothing gated at
       the same policy, outputs bit-identical;
    3. three thresholds in a row build no new suffix program;
    4. after one calibrating pass, the re-served trace's a-priori expected
       flops within ``CALIBRATION_TOL`` of the realized;
    5. a two-rung deadline ladder: each group's threshold is
       ``threshold_for_slack`` of its worst slack, deadline-free groups at
       the base;
    6. a journaled session with checkpoints and a ``"suffix"`` power
       failure answers every request exactly once, the recovered group's
       gate trace replaying into exact counters.

    Then times the plain, floor and gated sessions warm, in turns
    (:func:`timed_sessions`), and prints the ``adaptive`` line."""
    cuda = device.type == "cuda"
    flash = {}

    def flash_ok(name: str, run: dict, want: int) -> None:
        flash[name] = run["launches"]["flash_attention"]
        if layers_per_block is not None and cuda:
            check(flash[name] == want, f"{label}adaptive {name}: flash launched "
                  f"{flash[name]} times, expected {want}")

    # 1. The all-blocks floor.
    floor_engine = adaptive_engine(engine, threshold=float("inf"))
    floor = adaptive_session(floor_engine, requests)
    fs = floor["session"].stats
    check(fs.block_rows_gated == 0 and fs.flops_gated == 0 and fs.block_rows_fired > 0,
          f"{label}adaptive floor gated rows: {fs}")
    same_outputs(floor["responses"], clean["responses"], f"{label}adaptive floor")
    clean_flash = clean["row"]["launches"]["flash_attention"]
    flash_ok("floor", floor, clean_flash)
    check(fs.blocks_executed == clean["row"]["blocks_executed"],
          f"{label}adaptive floor executed {fs.blocks_executed} blocks")

    # 2. Gated, both modes; the unfused rung; LeNet-5 at the same policy.
    thr = block1_threshold(engine, requests)
    gated, engines = {}, {}
    for mode in ("early_exit", "per_block"):
        engines[mode] = adaptive_engine(engine, threshold=thr, mode=mode)
        gated[mode] = run = adaptive_session(engines[mode], requests)
        st = run["session"].stats
        check(st.block_rows_gated > 0 and st.flops_executed < fs.flops_executed,
              f"{label}adaptive {mode}: {st.block_rows_gated} rows gated, flops "
              f"{st.flops_executed} vs the floor's {fs.flops_executed}")
        flash_ok(mode, run, flash["floor"])
    ee = gated["early_exit"]
    check([g["trace"] for g in ee["groups"]] == [g["trace"] for g in gated["per_block"]["groups"]],
          f"{label}adaptive: early-exit and per-block gate traces differ")
    unfused_engine = engines["early_exit"]
    unfused_engine.executor.fused = False
    try:
        unfused = adaptive_session(unfused_engine, requests)
    finally:
        unfused_engine.executor.fused = True
    check([g["trace"] for g in unfused["groups"]] == [g["trace"] for g in ee["groups"]],
          f"{label}adaptive: the unfused rung's gate traces differ from the fused ones")
    unfused_err = same_outputs(unfused["responses"], ee["responses"],
                               f"{label}adaptive unfused", tol)
    flash_ok("unfused", unfused, flash["floor"])
    lenet_engine, lenet_requests, lenet_clean = lenet
    lenet_run = adaptive_session(adaptive_engine(lenet_engine, threshold=thr), lenet_requests)
    ls = lenet_run["session"].stats
    check(ls.block_rows_gated == 0 and ls.block_rows_fired > 0,
          f"lenet adaptive at threshold {thr}: {ls.block_rows_gated} rows gated")
    same_outputs(lenet_run["responses"], lenet_clean, "lenet adaptive")

    # 3. Three thresholds in a row: no new suffix program.
    ex = engines["early_exit"].executor
    programs = len(ex._compiled_fused)
    for scale in (0.9, 1.1, 1.0):
        ex.gater.threshold = thr * scale
        adaptive_session(engines["early_exit"], requests)
        check(len(ex._compiled_fused) == programs,
              f"{label}adaptive: threshold {thr * scale} built "
              f"{len(ex._compiled_fused) - programs} new suffix programs")

    # 4. Online calibration.
    cal_engine = adaptive_engine(engine, threshold=thr, calibrate_online=True)
    adaptive_session(cal_engine, requests)
    cal = adaptive_session(cal_engine, requests)["session"]
    cal_err = abs(cal.expected.flops_executed - cal.stats.flops_executed) / cal.stats.flops_executed
    check(cal_err <= CALIBRATION_TOL,
          f"{label}adaptive: calibrated expected flops {cal.expected.flops_executed} vs "
          f"realized {cal.stats.flops_executed} ({cal_err:.3%})")

    # 5. The deadline ladder.
    ladder = tuple((slack, thr * f) for slack, f in ADAPTIVE_RUNGS)
    ladder_engine = adaptive_engine(engine, threshold=thr, ladder=ladder)
    picks = []
    pick = ServingSession._ladder_threshold

    def recorded(self, members, now):
        got = pick(self, members, now)
        slacks = [p.slack(now) for p in members if p.deadline is not None]
        picks.append((min(slacks) if slacks else None, got))
        return got

    ServingSession._ladder_threshold = recorded
    try:
        lad = adaptive_session(ladder_engine, requests)
    finally:
        ServingSession._ladder_threshold = pick
    policy = ladder_engine.adaptive
    check(len(picks) == len(lad["groups"]), f"{label}ladder: {len(picks)} picks")
    for (slack, got), group in zip(picks, lad["groups"]):
        check(got == policy.threshold_for_slack(slack) == group["asked"] == group["threshold"],
              f"{label}ladder: slack {slack} picked {got}, ran at {group['threshold']}")
        check(slack is not None or got == thr, f"{label}ladder: a deadline-free group at {got}")
        check(slack is None or slack < ladder[-1][0] or got == ladder[-1][1],
              f"{label}ladder: slack {slack} did not take the tight rung")
    thresholds = sorted({got for _s, got in picks})
    check(len(thresholds) >= 2, f"{label}ladder: every group ran at {thresholds}")

    # 6. A journaled adaptive session through a "suffix" power failure.
    recovered = []
    execute = engines["early_exit"]._execute_group

    def recovering(group, *args, **kw):
        execution = execute(group, *args, **kw)
        if kw.get("first_task_resume", 0) > 0:
            recovered.append(execution)
        return execution

    engines["early_exit"]._execute_group = recovering  # journaled_session removes it
    ex.gater.threshold = thr
    journal = TimedJournal(MemoryJournalStore())
    injector = PowerFailureInjector(script=ADAPTIVE_POWER_SCRIPT)
    res = journaled_session(engines["early_exit"], requests, SESSION_POLICIES[STREAM_POLICY],
                            journal, injector, True)
    check(injector.injected["suffix"] == 1 and len(res["deaths"]) == 1,
          f"{label}adaptive journal: deaths {res['deaths']}")
    state = check_exactly_once(journal, len(requests), f"{label}adaptive journal ")
    check(len(recovered) >= 1, f"{label}adaptive journal: no group resumed from a checkpoint")
    for execution in recovered:
        check(execution.stats == execution.predicted
              and execution.gate_trace[0].fired is not None,
              f"{label}adaptive journal: the recovered group's trace did not replay exactly")
    journal_err = 0.0
    for seq, want in enumerate(ee["responses"]):
        for t, y in state.responses[seq]["outputs"].items():
            journal_err = max(journal_err, float(
                (y.to(device).float() - want.outputs[t].float()).abs().max()))
    check(journal_err <= tol, f"{label}adaptive journal: outputs vs the gated session "
          f"{journal_err}")

    # Warm session seconds and busy share: the plain session, the floor and
    # the gated one, in turns.
    timed = timed_sessions({"non_adaptive": engine, "floor": floor_engine,
                            "early_exit": engines["early_exit"]}, requests)

    def row_of(run: dict, name: str = None) -> dict:
        st = run["session"].stats
        n = run["session"].groups_executed
        out = {"first_drain_seconds": run["seconds"], "groups": n,
               "readbacks_per_group": run["readbacks"] / n,
               "readback_seconds_per_group": run["readback_seconds"] / n,
               "block_rows_fired": st.block_rows_fired, "block_rows_gated": st.block_rows_gated,
               "flops_gated_share_modelled": st.flops_gated / (st.flops_gated
                                                               + st.flops_executed),
               "launches": run["launches"]}
        if name is not None:
            warm = timed[name]
            out.update(warm_drain_seconds=warm["drain_seconds"],
                       busy=warm.get("busy"),
                       device_ms_per_group=warm["device_ms"] / n if "device_ms" in warm else None)
        return out

    plain = timed["non_adaptive"]
    row = {"engine": label.strip(), "policy": STREAM_POLICY, "threshold": thr,
           "non_adaptive": {"first_drain_seconds": clean["row"]["drain_seconds"],
                            "warm_drain_seconds": plain["drain_seconds"],
                            "busy": plain.get("busy"),
                            "device_ms_per_group": (plain["device_ms"] / clean["row"]["groups"]
                                                    if "device_ms" in plain else None),
                            "launches": clean["row"]["launches"]},
           "floor": row_of(floor, "floor"), "early_exit": row_of(ee, "early_exit"),
           "per_block": row_of(gated["per_block"]), "unfused": row_of(unfused),
           "unfused_max_abs_err": unfused_err, "fused_programs": programs,
           "calibrated_expected_flops_err": cal_err,
           "ladder_thresholds": thresholds, "ladder_groups": len(picks),
           "journal": {"deaths": res["deaths"], "resumes": res["resumes"],
                       "recovered_groups": len(recovered), "max_abs_err": journal_err},
           "lenet": {"block_rows_fired": ls.block_rows_fired,
                     "block_rows_gated": ls.block_rows_gated},
           "modelled_on": engine.hw.name}
    print(json.dumps({"adaptive": row}), flush=True)
    return {"row": row, "flash": flash}


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
# The bf16 SSD's three kernels, in launch order.
SSD_BF16_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel")
# The SSD backward's kernels, in launch order: eight on the CUDA cores
# (fp32), seven for bf16 (the chunk and the two pair kernels on the tensor
# cores).
SSD_BWD_KERNELS = ("ssd_bwd_chunk_kernel", "ssd_bwd_cb_kernel", "ssd_bwd_state_kernel",
                   "ssd_bwd_dkey_kernel", "ssd_bwd_dquery_kernel", "ssd_bwd_cum_kernel",
                   "ssd_bwd_reduce_kernel", "ssd_bwd_da_kernel")
SSD_BWD16_KERNELS = ("ssd_bwd_chunk_bf16_kernel", "ssd_bwd_state_kernel",
                     "ssd_bwd_dkey_bf16_kernel", "ssd_bwd_dquery_bf16_kernel",
                     "ssd_bwd_cum_kernel", "ssd_bwd_reduce_kernel", "ssd_bwd_da_kernel")
# The flash backward's three kernels by dtype, in launch order.
FLASH_BWD_KERNELS = {
    torch.float32: ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"),
    torch.bfloat16: ("flash_bwd_delta_kernel", "flash_bwd_dkdv_bf16_kernel",
                     "flash_bwd_dq_bf16_kernel"),
}
PORT_KERNELS = ("pearson_partial_kernel", "pearson_reduce_kernel", "flash_bf16_kernel",
                "flash_fp32_kernel", *dict.fromkeys(sum(FLASH_BWD_KERNELS.values(), ())),
                "ssd_scan_kernel", *SSD_BF16_KERNELS,
                *dict.fromkeys(SSD_BWD_KERNELS + SSD_BWD16_KERNELS))


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

def flash_bound(q: torch.Tensor, k: torch.Tensor, causal: bool, window) -> dict:
    """Least time on the card of ``roofline.flash_work`` for model-layout
    ``q`` (B, S, Hq, d) over ``k``/``v`` (B, T, Hk, d): 4 * B * Hq * pairs *
    d operations at the peak of the input type vs q, k, v and o moved once
    (K/V not repeated)."""
    b, s, hq, d = q.shape
    return roofline.bound(roofline.flash_work(b, s, k.shape[1], hq, k.shape[2], d, q.dtype,
                                              causal, window), q.dtype)


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


def flash_bwd_bound(q: torch.Tensor, k: torch.Tensor, causal: bool, window) -> dict:
    """Least time on the card of ``roofline.flash_bwd_work`` for the
    backward of model-layout ``q`` (B, S, Hq, d) over ``k``/``v`` (B, T, Hk,
    d): 10 * B * Hq * pairs * d operations (S = Q K^T again, dP = dO V^T,
    dV, dQ, dK: five products) at the peak of the input type, vs q, k, v, o,
    dO and the fp32 logsumexp read once and dQ, dK, dV written once."""
    b, s, hq, d = q.shape
    work = roofline.flash_bwd_work(b, s, k.shape[1], hq, k.shape[2], d, q.dtype, causal, window)
    return {**roofline.bound(work, q.dtype), "bytes": work["bytes"]}


def sdpa_backward_ms(q, k, v, d_o, causal: bool, window) -> float:
    """One ``scaled_dot_product_attention`` forward and backward under
    autograd, less its forward alone: the yardstick of the backward only."""
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    dot = d_o.transpose(1, 2)
    fwd = sdpa_call(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), causal, window)

    def both():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    def forward_only():
        with torch.no_grad():
            fwd()

    return cuda_ms(both, reps=10) - cuda_ms(forward_only, reps=10)


def flash_bwd_phase(device: torch.device) -> dict:
    """The flash backward (through ``FlashAttentionFunction``) vs the plain
    backward on the forward's own output and logsumexp, and vs autograd
    through the plain forward, at every row of :data:`FLASH_BWD` in fp32
    and bf16; two backward calls give the same bits; the forward without
    the logsumexp (inference) gives the same bits as with it.  Times the
    backward's three kernels (one wrapper call), the plain backward and
    SDPA's backward (the yardstick only) with CUDA events, and gives each of
    the three kernels' device time from one profiler window."""
    rng = np.random.default_rng(2)
    rows, max_err, max_abs = [], 0.0, 0.0
    for name, b, s, t, hq, hk, d, causal, window, real_t in FLASH_BWD:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(rng, (b, s, hq, d), dtype, device)
            k = _randn(rng, (b, t, hk, d), dtype, device)
            v = _randn(rng, (b, t, hk, d), dtype, device)
            d_o = _randn(rng, (b, s, hq, d), dtype, device)
            if real_t is not None:
                k[:, real_t:] = 0
                v[:, real_t:] = 0
            what = f"flash backward {name} {dtype}"
            geo = flash_module._geometry(q, k, causal, window)
            o_inf, _ = flash_module._forward(q, k, v, geo, with_lse=False)
            o, lse = flash_module._forward(q, k, v, geo, with_lse=True)
            check(torch.equal(o_inf, o), f"{what}: the forward differs with the logsumexp on")

            def grads():
                qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
                out = ops.flash_attention_bhsd(qg, kg, vg, causal=causal, window=window)
                return torch.autograd.grad(out, (qg, kg, vg), d_o)

            fwd0, bwd0 = flash_attention.launches, flash_attention.backward_launches
            first, second = grads(), grads()
            torch.cuda.synchronize()
            check(flash_attention.launches - fwd0 == 2 and
                  flash_attention.backward_launches - bwd0 == 2,
                  f"{what}: launches {flash_attention.launches - fwd0} forward, "
                  f"{flash_attention.backward_launches - bwd0} backward, expected 2 and 2")
            check(all(torch.equal(x, y) for x, y in zip(first, second)),
                  f"{what}: two backward calls differ")
            plain = flash_attention_bhsd_bwd_ref(q, k, v, o, d_o, lse, causal, window)
            qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
            auto = torch.autograd.grad(
                flash_attention_bhsd_ref(qf, kf, vf, causal, window), (qf, kf, vf), d_o.float())
            errs, auto_errs, abs_err = [], [], 0.0
            for got, want, ag in zip(first, plain, auto):
                diff = float((got.float() - want.float()).abs().max())
                abs_err = max(abs_err, diff)
                errs.append(diff / max(float(want.float().abs().max()), 1e-30))
                auto_errs.append(float((got.float() - ag).abs().max()
                                       / ag.abs().max().clamp_min(1e-30)))
            tol = FLASH_BWD_TOL[dtype]
            check(max(errs) <= tol and max(auto_errs) <= tol,
                  f"{what}: dq/dk/dv errors {errs} vs the plain backward, {auto_errs} vs "
                  f"autograd of the plain forward, of each one's largest |value|, > {tol}")
            max_err = max(max_err, *errs, *auto_errs)
            max_abs = max(max_abs, abs_err)
            del first, second, plain, auto, qf, kf, vf, o_inf
            big = s * t > 1024 * 1024
            row = {
                "kernel": "flash_attention_bwd", "path": name, "B": b, "S": s, "T": t,
                "Hq": hq, "Hk": hk, "d": d, "causal": causal, "window": window,
                "real_keys": real_t, "dtype": str(dtype).removeprefix("torch."),
                "max_abs_err": abs_err, "max_rel_err": errs, "max_rel_err_autograd": auto_errs,
                "bit_identical": True,
                "forward_unchanged_by_lse": True,
                "kernel_ms": cuda_ms(
                    lambda: flash_module._launch_bwd(q, k, v, o, d_o, lse, geo), reps=10),
                "plain_ms": cuda_ms(
                    lambda: flash_attention_bhsd_bwd_ref(q, k, v, o, d_o, lse, causal, window),
                    reps=3 if big else 10, warmup=1 if big else 5),
                "library_ms": sdpa_backward_ms(q, k, v, d_o, causal, window),
                **flash_bwd_bound(q, k, causal, window),
                "peak": ("bf16 tensor cores 989 TFLOP/s" if dtype == torch.bfloat16 else
                         "fp32 CUDA cores 67 TFLOP/s") + ", HBM 3.35 TB/s (H100 SXM data sheet)",
            }
            trace = device_breakdown(lambda: flash_module._launch_bwd(q, k, v, o, d_o, lse, geo),
                                     row["kernel_ms"])
            row["sub_kernels"] = {k: trace["port_kernels"].get(k, {}).get("ms")
                                  for k in FLASH_BWD_KERNELS[dtype]}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v, d_o, o, lse
            free_memory()
    return {"rows": rows, "max_rel_err": max_err, "max_abs_err": max_abs}


# --------------------------------------------------------------------------
# The SSD scan
# --------------------------------------------------------------------------

def ssd_bound(b: int, s: int, h: int, p: int, n: int, q: int, dtype: torch.dtype) -> dict:
    """Least time on the card of ``roofline.ssd_work``: B nc [2 Qc N + H (2
    Qc P + 4 Q N P)] operations (causal pairs only, Qc = Q (Q + 1) / 2) at
    the peak of the input type, against x, dt, a, B, C read once and y and
    the final state (fp32) written once."""
    work = roofline.ssd_work(b, s, h, p, n, q, dtype)
    return {**roofline.bound(work, dtype), "operations": work["flops"], "bytes": work["bytes"]}


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


def ssd_bwd_bound(b: int, s: int, h: int, p: int, n: int, q: int, dtype: torch.dtype,
                  with_final: bool) -> dict:
    """Least time on the card of ``roofline.ssd_bwd_work``: B nc [2 Qc N +
    H (4 Qc P + 4 Qc N + 10 Q N P)] operations at the peak of the input type
    against x, dy, dt, a, B, C (and the final state's cotangent) read once
    and dx, ddt, da, dB, dC written once."""
    work = roofline.ssd_bwd_work(b, s, h, p, n, q, dtype, with_final)
    return {**roofline.bound(work, dtype), "operations": work["flops"], "bytes": work["bytes"]}


def ssd_bwd_phase(device: torch.device) -> dict:
    """The SSD backward kernels (``ssd_scan_backward``) vs the plain backward
    ``ssd_scan_bwd_ref`` at every row of :data:`SSD_BWD`: each gradient
    within :data:`SSD_BWD_TOL` of its largest |value|, finite, and two calls
    bit-identical; the gradients through ``SSDScanFunction`` equal the
    backward kernels' and its forward the inference forward's bits.  Times
    the kernels (one wrapper call: eight in fp32, seven in bf16) and the
    plain backward with CUDA events, and each kernel's device time from one
    profiler window at every row, beside the scratch the call
    allocates and the bytes its bound counts; no single PyTorch call
    computes the SSD's backward."""
    rng = np.random.default_rng(6)
    rows, max_err, max_abs = [], 0.0, 0.0
    names = ("dx", "ddt", "da", "dB", "dC")
    for path, b, s, h, p, n, q, dtype, with_final in SSD_BWD:
        x, dt, a, bb, cc = ssd_inputs(rng, b, s, h, p, n, dtype, device)
        dy = _randn(rng, (b, s, h, p), dtype, device)
        d_final = _randn(rng, (b, h, p, n), torch.float32, device) if with_final else None
        what = f"ssd backward {path} B {b} S {s} H {h} P {p} N {n} chunk {q} {dtype}"
        bwd0 = ssd_scan.backward_launches
        first = ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, q)
        second = ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, q)
        torch.cuda.synchronize()
        check(ssd_scan.backward_launches - bwd0 == 2, f"{what}: backward launches")
        check(all(torch.equal(u, v) for u, v in zip(first, second)),
              f"{what}: two backward calls differ")
        plain = ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, d_final, q)
        errs, abs_err = {}, 0.0
        for name, got, want in zip(names, first, plain):
            check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: {name} dtype/shape")
            check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite {name}")
            diff = float((got.float() - want.float()).abs().max())
            abs_err = max(abs_err, diff)
            errs[name] = diff / max(float(want.float().abs().max()), 1e-30)
        tol = SSD_BWD_TOL[dtype]
        check(max(errs.values()) <= tol,
              f"{what}: errors {errs} of each gradient's largest |value| > {tol}")
        max_err, max_abs = max(max_err, *errs.values()), max(max_abs, abs_err)
        if not with_final:
            # Through autograd: the inference forward's bits, the kernels' gradients.
            with torch.no_grad():
                y0, f0 = ops.ssd_scan(x, dt, a, bb, cc, q)
            leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bb, cc)]
            y1, f1 = ops.ssd_scan(*leaves, q)
            check(torch.equal(y1.detach(), y0) and torch.equal(f1.detach(), f0),
                  f"{what}: the forward under grad differs from inference")
            auto = torch.autograd.grad(y1, leaves, dy)
            check(all(torch.equal(u, v) for u, v in zip(auto, first)),
                  f"{what}: SSDScanFunction's gradients differ from the kernels'")
            del y0, f0, y1, f1, auto, leaves
        del second, plain
        free_memory()
        big = s >= 1024
        row = {
            "kernel": "ssd_scan_bwd", "path": path, "shape": [b, s, h, p, n, q],
            "dtype": str(dtype).removeprefix("torch."), "d_final": with_final,
            "max_abs_err": abs_err, "max_rel_err": errs, "bit_identical": True,
            "kernel_ms": cuda_ms(lambda: ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, q),
                                 reps=10 if big else 20),
            "plain_ms": cuda_ms(lambda: ssd_scan_bwd_ref(x, dt, a, bb, cc, dy, d_final, q),
                                reps=3 if big else 10, warmup=1 if big else 3),
            "library_ms": None,
            # What the wrapper allocated in this row's calls, beside what
            # backward_scratch_shapes lays out (each buffer before rounding).
            "scratch_bytes": ssd_scan.backward_scratch_allocated,
            "scratch_bytes_layout": ssd_backward_scratch_bytes(b, s, h, p, n, q, dtype),
            **ssd_bwd_bound(b, s, h, p, n, q, dtype, with_final),
            "peak": ("bf16 tensor cores 989 TFLOP/s" if dtype == torch.bfloat16 else
                     "fp32 CUDA cores 67 TFLOP/s") + ", HBM 3.35 TB/s (H100 SXM data sheet)",
        }
        trace = device_breakdown(lambda: ssd_scan_backward(x, dt, a, bb, cc, dy, d_final, q),
                                 row["kernel_ms"])
        row["sub_kernels"] = {k: trace["port_kernels"].get(k, {}).get("ms") for k in (
            SSD_BWD16_KERNELS if dtype == torch.bfloat16 else SSD_BWD_KERNELS)}
        row["busy"] = trace["busy"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, dt, a, bb, cc, dy, d_final, first
        free_memory()
    return {"rows": rows, "max_rel_err": max_err, "max_abs_err": max_abs}


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
    return {"pearson_gram": 0, "flash_attention": flash, "flash_attention_bwd": 0,
            "ssd_scan": ssd, "ssd_scan_bwd": 0}


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


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention():
    """The models' full-sequence attention through the plain version on the
    card, under autograd (the plain route of the training gates): the flash
    kernels do not run."""
    kernel = ops.flash_attention_bhsd
    ops.flash_attention_bhsd = flash_attention_bhsd_ref
    try:
        yield
    finally:
        ops.flash_attention_bhsd = kernel


@contextlib.contextmanager
def plain_ssd():
    """The models' SSD through its plain versions on the card: the SSD
    kernels do not run."""
    kernel = ops.ssd_scan
    ops.ssd_scan = lambda x, dt, a, b_in, c_in, chunk=128: PlainSSDFunction.apply(
        x, dt, a, b_in, c_in, chunk)
    try:
        yield
    finally:
        ops.ssd_scan = kernel


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_steps(device: torch.device, model, params, batches, steps: int) -> dict:
    """``steps`` AdamW steps (lr 3e-4, warmup 1) through ``make_train_step``
    on ``batches[:steps]``, each timed on the host clock to a sync, the
    launch counts zeroed before them; then one more step on ``batches[-1]``
    under the profiler (its launches are not the gates'; on the CPU it is
    not profiled).  Returns the new params and optimizer state, the losses,
    grad norms, step ms and their median after the first, the steps'
    launches and peak memory, and the profiled step's breakdown."""
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps))
    reset_launch_counts()
    reset_peak(device)
    losses, gnorms, step_ms = [], [], []
    for tokens in batches[:steps]:
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, tokens)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches, peak = launch_counts(), peak_gb(device)
    steady_ms = statistics.median(step_ms[1:])
    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], _ = step_fn(state["params"], state["opt"], batches[-1])

    breakdown = (device_breakdown(one_step, steady_ms, top=8, warm=False, cpu=False)
                 if device.type == "cuda" else {"busy": None})
    return {"params": state["params"], "opt": state["opt"], "losses": losses,
            "grad_norms": gnorms, "step_ms": step_ms, "steady_ms": steady_ms,
            "launches": launches, "peak_gb": peak, "breakdown": breakdown}


def train_phase(device: torch.device, cfg=None, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ, steps: int = TRAIN_STEPS) -> dict:
    """LM training on mistral-nemo-12b at full width, 8 of its 40 layers,
    remat on, B x S tokens of ``lm_batches(seed=0)``.  Gates: the first
    batch's loss and grad norm through the kernels within 2e-2 of the plain
    route's on the same card from the same params, and each attention
    weight's gradient within 5e-2 of its largest |value|; ``grad_accum=2``
    the same loss within 2e-2; flash twice per layer (forward and remat)
    and its backward once per layer in every step; the loss falls over
    ``TRAIN_STEPS`` AdamW steps; a checkpoint of params and optimizer state
    restores bit-exactly.  Prints step ms, tokens/s, model FLOPs per second
    over the bf16 peak, peak memory, the device's busy share and the top
    kernels of one more step (on the card; on the CPU, for a rehearsal with
    a smoke ``cfg``, the launch counts are 0 and not gated)."""
    if cfg is None:
        cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS)
        check(cfg.remat, "the full config trains with remat")
    on_card = device.type == "cuda"
    fwd_per_layer = 2 if cfg.remat else 1
    model = get_model(cfg)
    layers = cfg.num_layers
    laps = Laps(device)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    it = lm_batches(cfg.vocab_size, batch, seq, seed=0)
    batches = [next(it) for _ in range(steps + 1)]
    laps.lap("init")

    # The plain route: the same loss and gradients with the plain attention.
    reset_launch_counts()
    with plain_attention():
        loss_p, _, grads = loss_and_grads(model, params, batches[0])
        gnorm_p = float(global_norm(grads))
    plain_launches = launch_counts()
    check(plain_launches["flash_attention"] == 0 == plain_launches["flash_attention_bwd"],
          f"the plain route launched flash: {plain_launches}")
    attn_plain = dict(grads["layers"]["attn"])
    del grads
    free_memory()
    laps.lap("plain_route")

    reset_launch_counts()
    reset_peak(device)
    loss_k, _, grads = loss_and_grads(model, params, batches[0])
    grad_launches = launch_counts()
    gnorm_k = float(global_norm(grads))
    grads_peak = peak_gb(device)
    check(not on_card or (grad_launches["flash_attention"] == fwd_per_layer * layers
                          and grad_launches["flash_attention_bwd"] == layers),
          f"one batch's gradients: launches {grad_launches}, expected flash "
          f"{fwd_per_layer * layers} "
          f"(forward and remat) and its backward {layers}")
    loss_rel, gnorm_rel = rel(float(loss_k), float(loss_p)), rel(gnorm_k, gnorm_p)
    check(loss_rel <= TRAIN_LOSS_TOL and gnorm_rel <= TRAIN_LOSS_TOL,
          f"kernel vs plain route: loss {float(loss_k)} vs {float(loss_p)}, grad norm "
          f"{gnorm_k} vs {gnorm_p}, > {TRAIN_LOSS_TOL} relative")
    attn_err = {}
    for name, want in attn_plain.items():
        got = grads["layers"]["attn"][name]
        check(float(got.abs().max()) > 0, f"attention weight {name} got no gradient")
        attn_err[name] = float((got.float() - want.float()).abs().max()
                               / want.float().abs().max().clamp_min(1e-30))
    check(max(attn_err.values()) <= TRAIN_GRAD_TOL,
          f"attention weights' gradients vs the plain route's: {attn_err} > {TRAIN_GRAD_TOL} "
          "of each one's largest |value|")
    del grads, attn_plain
    free_memory()
    laps.lap("kernel_route")

    reset_launch_counts()
    loss_a, _, grads = loss_and_grads(model, params, batches[0], grad_accum=2)
    accum_launches = launch_counts()
    del grads
    free_memory()
    accum_rel = rel(float(loss_a), float(loss_k))
    check(accum_rel <= TRAIN_LOSS_TOL,
          f"grad_accum 2 loss {float(loss_a)} vs {float(loss_k)} > {TRAIN_LOSS_TOL} relative")
    check(not on_card or accum_launches["flash_attention_bwd"] == 2 * layers,
          f"grad_accum 2: launches {accum_launches}")
    laps.lap("grad_accum")

    run = train_steps(device, model, params, batches, steps)
    params, opt, losses, step_launches = run["params"], run["opt"], run["losses"], run["launches"]
    steady_ms, breakdown = run["steady_ms"], run["breakdown"]
    check(not on_card or (step_launches["flash_attention"] == fwd_per_layer * layers * steps
                          and step_launches["flash_attention_bwd"] == layers * steps),
          f"{steps} train steps: launches {step_launches}, expected flash "
          f"{fwd_per_layer * layers} and its backward {layers} a step")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"the loss did not fall over {steps} steps: {losses}")
    laps.lap("steps_and_profiled_step")

    # A checkpoint of params and optimizer state round-trips bit-exactly:
    # bf16 weights, fp32 moments, the int32 step.
    tree = {"params": {"final_norm": params["final_norm"],
                       "layers": {"attn": {"wo": params["layers"]["attn"]["wo"]}}},
            "opt": AdamWState(step=opt.step, mu={"final_norm": opt.mu["final_norm"]},
                              nu={"final_norm": opt.nu["final_norm"]})}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"ckpt_{steps}.npz")
        save_checkpoint(path, tree, step=steps)
        restored, step = restore_checkpoint(path, tree)
    pairs = list(zip(tree_leaves(tree), tree_leaves(restored)))
    check(step == steps and all(a.dtype == b.dtype and a.device == b.device
                                      and torch.equal(a, b) for a, b in pairs),
          "the checkpoint did not round-trip bit-exactly")
    laps.lap("checkpoint")

    flops = roofline.train_model_flops(cfg, batch, seq)
    row = {
        "arch": cfg.name, "layers": layers, "batch": batch, "seq": seq,
        "remat": cfg.remat, "steps": steps,
        "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel": loss_rel,
        "grad_norm_kernel": gnorm_k, "grad_norm_plain": gnorm_p, "grad_norm_rel": gnorm_rel,
        "attn_grad_rel_err": attn_err, "loss_grad_accum_2": float(loss_a),
        "grad_accum_rel": accum_rel, "losses": losses, "grad_norms": run["grad_norms"],
        "step_ms": run["step_ms"], "steady_step_ms": steady_ms,
        "tokens_per_s": batch * seq / (steady_ms / 1e3),
        "model_flops_per_step": flops,
        "mfu_weights_and_pairs": roofline.step_mfu(flops, steady_ms / 1e3),
        "peak_memory_gb": {"gradients": grads_peak, "steps": run["peak_gb"]},
        "launches": {"gradients": grad_launches, "grad_accum_2": accum_launches,
                     "steps": step_launches},
        "busy": breakdown["busy"], "device_breakdown": breakdown,
        "checkpoint_bit_exact": True, "seconds": laps.seconds,
    }
    del tree, restored, pairs, run
    row["counted"] = count_step(device, model, params, opt, batches[-1], steady_ms, cfg.name)
    del params, opt
    print(json.dumps({"train": row}), flush=True)
    free_memory()
    return row


def param_count(cfg, params) -> int:
    """The reference's parameter count: the tree's bytes over the params
    dtype's size (an fp32 leaf, a MoE router, counts twice in bf16)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(params))
               / cfg.params_dtype().itemsize)


def count_step(device: torch.device, model, params, opt, batch, steady_ms: float,
               label: str) -> dict:
    """One more train step of ``model`` (AdamW, the timed steps' settings)
    counted by ``analyze_step`` on ``device``, and the same step on meta
    tensors: parameters from ``param_shapes``, moments from ``opt_shapes``, a
    meta batch.  Gates: equal FLOPs, to the FLOP; bytes within
    :data:`COUNT_BYTES_TOL`; the same kernels counted, each launch once by
    its formula, and on the card as often as the wrappers launched them.
    Returns the counts, the aten ops whose counts differ between the two
    runs, ``mfu`` (the reference's model FLOPs, 6 N D over active params,
    per steady second over the bf16 peak), the counted FLOPs' share,
    ``roofline_share`` (the counted work's least time over the steady step;
    at most :data:`ROOFLINE_SHARE_MAX` on the card) and the meta step's
    peak live bytes beside ``max_memory_allocated`` of the card's step.
    The step's results are dropped."""
    cfg = model.cfg
    on_card = device.type == "cuda"
    step_fn = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=1,
                                                 total_steps=TRAIN_STEPS))
    t0 = time.perf_counter()
    free_memory()
    reset_peak(device)
    reset_launch_counts()
    card = analyze_step(step_fn, params, opt, batch)
    sync(device)
    launched = launch_counts()
    card_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    card_args = sum(t.numel() * t.element_size() for t in tree_leaves([params, opt]))
    t_card = time.perf_counter() - t0
    meta_params = param_shapes(model)
    meta = analyze_step(step_fn, meta_params, opt_shapes(meta_params),
                        torch.empty(np.shape(batch), dtype=torch.int32, device="meta"))
    t_meta = time.perf_counter() - t0 - t_card
    check(card["flops"] == meta["flops"],
          f"{label}: the step counts {card['flops']} FLOPs on {device.type}, "
          f"{meta['flops']} on meta")
    bytes_rel = rel(meta["bytes"], card["bytes"])
    differ = {op: {device.type: card["ops"].get(op), "meta": meta["ops"].get(op)}
              for op in sorted(set(card["ops"]) | set(meta["ops"]))
              if card["ops"].get(op) != meta["ops"].get(op)}
    check(bytes_rel <= COUNT_BYTES_TOL,
          f"{label}: counted bytes {card['bytes']} on {device.type}, {meta['bytes']} on meta "
          f"({bytes_rel:.4f} > {COUNT_BYTES_TOL}); ops that differ: {differ}")
    check(card["kernels"] == meta["kernels"],
          f"{label}: kernels counted {card['kernels']} vs on meta {meta['kernels']}")
    check(not on_card or all(launched[k] == v["launches"] for k, v in card["kernels"].items()),
          f"{label}: kernels counted {card['kernels']} but launched {launched}")
    n = param_count(cfg, params)
    model_flops = roofline.model_flops_estimate(
        cfg, InputShape("train", np.shape(batch)[1], np.shape(batch)[0], "train"), n,
        roofline.active_params(cfg, n))
    step_s = steady_ms / 1e3
    share = roofline.roofline_share(card["flops"], card["bytes"], step_s)
    check(not on_card or share <= ROOFLINE_SHARE_MAX,
          f"{label}: roofline_share {share} > {ROOFLINE_SHARE_MAX}: a count makes the card "
          "look faster than its peak")
    out = {
        "flops": card["flops"], "bytes": {device.type: card["bytes"], "meta": meta["bytes"]},
        "bytes_rel": bytes_rel, "ops_that_differ": differ, "kernels": card["kernels"],
        "model_flops": model_flops, "steady_step_ms": steady_ms,
        "mfu": roofline.step_mfu(model_flops, step_s),
        "counted_flops_share": card["flops"] / step_s / roofline.PEAK_FLOPS,
        "t_compute_ms": card["flops"] / roofline.PEAK_FLOPS * 1e3,
        "t_memory_ms": card["bytes"] / roofline.HBM_BW * 1e3,
        "roofline_share": share,
        "peak_bytes": {"meta_dry_run": meta["peak_bytes"] + card_args,
                       "card_counted": card["peak_bytes"] + card_args,
                       "card_max_memory_allocated": card_peak},
        "seconds": {"card": t_card, "meta": t_meta},
    }
    del card, meta, meta_params
    free_memory()
    return out


def dryrun_phase(smi: str, counted: dict) -> dict:
    """The launch analysis.  (a) ``python -m repro_torch.launch.dryrun`` in
    one subprocess per :data:`DRYRUN_CASES` (a fake world cannot share a
    process with this one's NCCL worlds), all started together, at full width
    and depth on the 16 x 16 mesh.  Gates: ``status`` ok; FLOPs, bytes and
    collective bytes positive; ``model_flops`` equal to
    ``model_flops_estimate`` of the config's own parameter count; each
    kernel's counted launches those the step makes (a train step with remat:
    the forward twice and the backward once per layer; a prefill: once);
    ``hlo_flops`` at most :data:`DRYRUN_FLOPS_SLACK` times the same plan's
    FLOPs counted in a world of one in the same subprocess
    (``--world-of-one``): each rank does only its share.
    (b) ``counted``, the steps :func:`count_step` counted in the training
    phases.  Prints the ``dryrun`` line with the card's name and power
    limit."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", "single", "--policy", policy, "--out", out, "--world-of-one"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for arch, shape, policy in DRYRUN_CASES]
        try:
            logs = [p.communicate(timeout=DRYRUN_SECONDS) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = {}
        for (arch, shape, _policy), p, (stdout, stderr) in zip(DRYRUN_CASES, procs, logs):
            check(p.returncode == 0, f"dry run {arch} {shape}: rc {p.returncode}: {stderr[-2000:]}")
            with open(os.path.join(out, f"{arch}__{shape}__single.json")) as fh:
                results[f"{arch}/{shape}"] = json.load(fh)
    rows = {}
    for (arch, shape, policy), r in zip(DRYRUN_CASES, results.values()):
        label = f"dry run {arch} {shape}"
        check(r["status"] == "ok", f"{label}: {r.get('error')}\n{r.get('traceback', '')[-3000:]}")
        check(policy == "auto" or r["policy"] == policy, f"{label}: policy {r['policy']}")
        check(r["hlo_flops"] > 0 and r["hlo_bytes"] > 0 and r["coll_bytes"] > 0,
              f"{label}: FLOPs {r['hlo_flops']}, bytes {r['hlo_bytes']}, collective bytes "
              f"{r['coll_bytes']}")
        cfg = get_config(arch)
        n = param_count(cfg, param_shapes(get_model(cfg)))
        kind = r["kind"]
        want_mf = roofline.model_flops_estimate(cfg, get_shape(shape), n,
                                                roofline.active_params(cfg, n))
        check(r["n_params"] == n and r["model_flops"] == want_mf,
              f"{label}: n_params {r['n_params']} vs {n}, model_flops {r['model_flops']} vs "
              f"{want_mf}")
        once = prefill_launches(cfg)
        fwd = 2 if kind == "train" and cfg.remat else 1
        want = {k: fwd * v for k, v in once.items() if v}
        if kind == "train":
            want.update({f"{k}_bwd": v for k, v in once.items() if v})
        got = {k: v["launches"] for k, v in r["kernels"].items()}
        check(got == want, f"{label}: kernels counted {got}, the step launches {want}")
        one = r["world_of_one"]["flops"]
        check(0 < r["hlo_flops"] <= DRYRUN_FLOPS_SLACK * one,
              f"{label}: FLOPs over 256 ranks {r['hlo_flops']}, {r['flops_factor']:.3f} times "
              f"the world of one's {one}")
        rows[f"{arch}/{shape}"] = {k: r[k] for k in (
            "policy", "n_params", "trace_s", "memory", "kernels", "hlo_flops", "hlo_bytes",
            "coll_bytes", "coll_breakdown", "model_flops", "t_compute", "t_memory",
            "t_collective", "dominant", "useful_flops_ratio", "world_of_one", "flops_factor")}
        rows[f"{arch}/{shape}"]["peak_bytes"] = r["memory"]["peak_bytes"]
    line = {"device": smi, "mesh": "16x16 (fake world of 256)", "cases": rows,
            "counted_steps": counted, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"dryrun": line}), flush=True)
    return line


def train_launcher_phase(arch: str, steps: int, batch: int, seq: int, extra_args=()) -> dict:
    """``python -m repro_torch.launch.train --arch <arch>`` in-process at the
    full config: whisper-medium's encoder and cross-attention run the flash
    backward without the causal mask over keys zero-padded to its
    ``attn_chunk``; mamba2-780m's Mamba2 layers the SSD backward.  Checks
    its step lines and tokens/s line, finite losses, flash twice per
    attention layer per step (forward and remat) and its backward once, and
    the SSD twice per Mamba2 layer and its backward once."""
    cfg = get_config(arch)
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            *extra_args]
    on_card = "cpu" not in extra_args
    buf = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        out = train_launcher.main(argv)
    launches = launch_counts()
    text = buf.getvalue()
    print(text, end="", flush=True)
    once = prefill_launches(cfg)  # one launch per attention layer, per Mamba2 layer
    attn_layers, ssd_layers = once["flash_attention"], once["ssd_scan"]
    check("step    0 loss" in text and "tok/s" in text, f"train launcher printed {text!r}")
    check(all(np.isfinite(h["loss"]) for h in out["history"]), f"losses {out['history']}")
    check(not on_card or (launches["flash_attention"] == 2 * attn_layers * steps
                          and launches["flash_attention_bwd"] == attn_layers * steps
                          and launches["ssd_scan"] == 2 * ssd_layers * steps
                          and launches["ssd_scan_bwd"] == ssd_layers * steps),
          f"train launcher: launches {launches}, expected flash {2 * attn_layers} and its "
          f"backward {attn_layers}, the SSD {2 * ssd_layers} and its backward {ssd_layers} "
          "a step")
    del out
    free_memory()
    return {"launches": launches, "line": text.strip().splitlines()[-1]}


def ssm_leaves(cfg, tree) -> dict:
    """The Mamba2 layers' leaves of a params or gradient tree (the SSM
    family's ``layers``, the hybrid's ``mamba``), by name: their gradients
    all pass through the SSD's backward (x and its projection, dt and
    ``dt_bias``, a and ``a_log``, B, C and their projections, the conv)."""
    return tree["layers"] if cfg.family == "ssm" else tree["mamba"]


SSM_SSD_LEAVES = ("w_zx", "wb", "wc", "wdt", "dt_bias", "a_log", "conv")


def train_ssm_phase(device: torch.device, cfg, batch: int, seq: int, steps: int,
                    count: bool = False) -> dict:
    """SSM or hybrid training at ``cfg``'s width and depth, remat on, B x S
    tokens of ``lm_batches(seed=0)``.  Gates: the first batch's loss and
    grad norm through the kernels within 2e-2 of the plain route's (the
    SSD's plain forward and backward, the plain attention) on the same card
    from the same params; every leaf's gradient finite, and each Mamba2
    leaf whose gradient passes through the SSD backward nonzero; the SSD
    twice per Mamba2 layer (forward and remat) and its backward once, and a
    hybrid's flash forward and backward once per shared-attention
    invocation, in every step; the loss falls over ``steps`` AdamW steps;
    on an fp32 copy of ``cfg`` cut to :data:`SSM_FP32_CHECK_LAYERS`, every
    leaf's gradient within :data:`SSM_FP32_GRAD_TOL` of the plain route's.
    Prints step ms, tokens/s, peak memory, the device's busy share and the
    top kernels of one more step (on the CPU, for a rehearsal with a smoke
    ``cfg``, the launch counts are 0 and not gated).  With ``count``, one
    more step is counted on the card and on meta (:func:`count_step`)."""
    on_card = device.type == "cuda"
    model = get_model(cfg)
    ssd_layers = cfg.num_layers
    fwd_per_layer = 2 if cfg.remat else 1
    attn = prefill_launches(cfg)["flash_attention"]  # shared-attention invocations
    laps = Laps(device)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    it = lm_batches(cfg.vocab_size, batch, seq, seed=0)
    batches = [next(it) for _ in range(steps + 1)]
    laps.lap("init")

    reset_launch_counts()
    with plain_attention(), plain_ssd():
        loss_p, _, grads = loss_and_grads(model, params, batches[0])
        gnorm_p = float(global_norm(grads))
    plain_launches = launch_counts()
    check(not any(plain_launches.values()), f"the plain route launched kernels: {plain_launches}")
    ssm_plain = {k: ssm_leaves(cfg, grads)[k] for k in SSM_SSD_LEAVES}
    del grads
    free_memory()
    laps.lap("plain_route")

    reset_launch_counts()
    reset_peak(device)
    loss_k, _, grads = loss_and_grads(model, params, batches[0])
    grad_launches = launch_counts()
    gnorm_k = float(global_norm(grads))
    grads_peak = peak_gb(device)
    expected = {"ssd_scan": fwd_per_layer * ssd_layers, "ssd_scan_bwd": ssd_layers,
                "flash_attention": attn, "flash_attention_bwd": attn, "pearson_gram": 0}
    check(not on_card or grad_launches == expected,
          f"{cfg.name}: one batch's gradients launched {grad_launches}, expected {expected}")
    loss_rel, gnorm_rel = rel(float(loss_k), float(loss_p)), rel(gnorm_k, gnorm_p)
    check(loss_rel <= TRAIN_LOSS_TOL and gnorm_rel <= TRAIN_LOSS_TOL,
          f"{cfg.name} kernel vs plain route: loss {float(loss_k)} vs {float(loss_p)}, grad norm "
          f"{gnorm_k} vs {gnorm_p}, > {TRAIN_LOSS_TOL} relative")
    check(all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
          f"{cfg.name}: a non-finite gradient")
    ssm_err = {}
    for name, want in ssm_plain.items():
        got = ssm_leaves(cfg, grads)[name]
        check(float(got.abs().max()) > 0, f"{cfg.name}: Mamba2 leaf {name} got no gradient")
        ssm_err[name] = float((got.float() - want.float()).abs().max()
                              / want.float().abs().max().clamp_min(1e-30))
    del grads, ssm_plain
    free_memory()
    laps.lap("kernel_route")

    # Every leaf's gradient, kernel vs plain route, on an fp32 copy at full
    # width and a few layers.
    cfg32 = dataclasses.replace(cfg, num_layers=SSM_FP32_CHECK_LAYERS[cfg.family],
                                dtype="float32", param_dtype="float32")
    model32 = get_model(cfg32)
    params32 = model32.init(torch.Generator(device=device).manual_seed(1), device)
    with plain_attention(), plain_ssd():
        _loss, _, want32 = loss_and_grads(model32, params32, batches[0])
    reset_launch_counts()
    _loss, _, got32 = loss_and_grads(model32, params32, batches[0])
    fp32_launches = launch_counts()
    check(not on_card or fp32_launches["ssd_scan_bwd"] == cfg32.num_layers,
          f"{cfg.name} fp32 copy: launches {fp32_launches}")
    fp32_err = {}
    for path, (got, want) in zip(
            (f"leaf {i}" for i in range(len(tree_leaves(got32)))),
            zip(tree_leaves(got32), tree_leaves(want32))):
        fp32_err[path] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    worst = max(fp32_err, key=fp32_err.get)
    check(fp32_err[worst] <= SSM_FP32_GRAD_TOL,
          f"{cfg.name} fp32, {cfg32.num_layers} layers: gradient {worst} differs from the plain "
          f"route's by {fp32_err[worst]} of its largest |value| > {SSM_FP32_GRAD_TOL}")
    del params32, want32, got32
    free_memory()
    laps.lap("fp32_check")

    run = train_steps(device, model, params, batches, steps)
    losses, steady_ms = run["losses"], run["steady_ms"]
    check(not on_card or run["launches"] == {k: v * steps for k, v in expected.items()},
          f"{cfg.name}: {steps} train steps launched {run['launches']}, expected {expected} "
          "a step")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{cfg.name}: the loss did not fall over {steps} steps: {losses}")
    laps.lap("steps_and_profiled_step")
    row = {
        "arch": cfg.name, "layers": cfg.num_layers, "batch": batch, "seq": seq,
        "remat": cfg.remat, "dtype": cfg.dtype,
        "steps": steps, "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
        "loss_rel": loss_rel, "grad_norm_kernel": gnorm_k, "grad_norm_plain": gnorm_p,
        "grad_norm_rel": gnorm_rel, "ssm_grad_rel_err_bf16": ssm_err,
        "fp32_check": {"layers": cfg32.num_layers, "max_grad_rel_err": fp32_err[worst],
                       "leaves": len(fp32_err), "launches": fp32_launches},
        "losses": losses,
        "grad_norms": run["grad_norms"], "step_ms": run["step_ms"], "steady_step_ms": steady_ms,
        "tokens_per_s": batch * seq / (steady_ms / 1e3),
        "peak_memory_gb": {"gradients": grads_peak, "steps": run["peak_gb"]},
        "launches": {"gradients": grad_launches, "steps": run["launches"]},
        "busy": run["breakdown"]["busy"], "device_breakdown": run["breakdown"],
        "seconds": laps.seconds,
    }
    params, opt = run["params"], run["opt"]
    del run
    if count:
        row["counted"] = count_step(device, model, params, opt, batches[-1], steady_ms, cfg.name)
    print(json.dumps({"train_ssm": row}), flush=True)
    del params, opt
    free_memory()
    return row


def multitask_eval_loss(program, flat, batches) -> float:
    """The mean joint multitask loss of ``flat`` over ``batches``, no grad."""
    device = program.device
    total = 0.0
    with torch.no_grad():
        for tokens in batches:
            total += float(multitask_loss(
                program, flat, torch.as_tensor(tokens, device=device),
                torch.as_tensor(train_example.task_labels(tokens), device=device)))
    return total / len(batches)


def train_multitask_phase(device: torch.device, steps: int, batch: int, seq: int,
                          cfg=None) -> dict:
    """``repro_torch.examples.train_multitask`` at its reference size (the
    ~100M granite-family backbone, fp32, the 4-level graph of 10 nodes of 2
    layers; ``cfg`` shrinks it for a rehearsal): ``steps`` AdamW steps of B
    x S tokens.  Gates: finite losses; the training loss (the joint loss
    over every batch the steps trained on) lower after the steps than
    before them — the per-step losses, each on a batch the model has not
    seen, vary more from batch to batch than they fall in a few tens of
    steps at lr 1e-4, and the loss on the next, unseen batch is printed
    beside it; per step the flash kernel forward and its backward once per
    layer of every node (20 each).  Prints step ms and tokens/s."""
    on_card = device.type == "cuda"
    cfg = cfg if cfg is not None else train_example.backbone_config()
    program = train_example.build_program(cfg, seq, device)
    order = train_example.serving_order(program)
    ranges = _split_layers(cfg.num_layers, program.graph.depth)
    per_step = sum(ranges[node[0]][1] - ranges[node[0]][0] for node in program.graph.nodes())
    flat = train_example.program_trainable_params(program)
    n_params = sum(t.numel() for t in tree_leaves(flat))
    it = lm_batches(cfg.vocab_size, batch, seq, seed=0)  # the batches train() draws
    seen = [next(it) for _ in range(steps)]
    unseen = [next(it)]
    before = multitask_eval_loss(program, flat, seen)
    unseen_before = multitask_eval_loss(program, flat, unseen)
    reset_launch_counts()
    reset_peak(device)
    t0 = time.perf_counter()
    out = train_example.train(program, cfg.vocab_size, steps, batch, seq, log=None)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    after = multitask_eval_loss(program, out["flat"], seen)
    unseen_after = multitask_eval_loss(program, out["flat"], unseen)
    losses = [h["loss"] for h in out["history"]]
    check(all(np.isfinite(losses)) and np.isfinite(after) and after < before,
          f"train_multitask: the training loss went {before} -> {after}; per step {losses}")
    check(not on_card or (launches["flash_attention"] == per_step * steps
                          and launches["flash_attention_bwd"] == per_step * steps),
          f"train_multitask: launches {launches}, expected flash and its backward "
          f"{per_step} a step")
    step_ms = statistics.median(h["seconds"] for h in out["history"][1:]) * 1e3
    row = {"params": n_params, "nodes": len(program.node_params), "order": order,
           "steps": steps, "batch": batch, "seq": seq, "training_loss": [before, after],
           "unseen_batch_loss": [unseen_before, unseen_after],
           "losses": losses, "flash_per_step": per_step, "launches": launches,
           "steady_step_ms": step_ms, "tokens_per_s": batch * seq / (step_ms / 1e3),
           "seconds": seconds, "peak_memory_gb": peak_gb(device)}
    print(json.dumps({"train_multitask": row}), flush=True)
    del program, out, flat
    free_memory()
    return row


def serve_multitask_phase(device: torch.device) -> dict:
    """``repro_torch.examples.serve_multitask`` run whole: its four segments'
    lines are printed and checked — Antler's modelled reduction over
    Vanilla above 1x, executed counters equal to the prediction in the
    session and the adaptive arm, the LM segment's 4 x 16 tokens, with one
    flash launch per layer of its prefill."""
    buf = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        out = serve_example.main([], device=device)
    launches = launch_counts()
    text = buf.getvalue()
    print(text, end="", flush=True)
    lm_cfg = serve_example.get_smoke_config(serve_example.LM_ARCH)
    check(out["audio"]["reduction"] > 1.0, f"serve_multitask: reduction {out['audio']}")
    check(out["session"]["stats_equal_predicted"] and out["adaptive"]["stats_equal_predicted"],
          "serve_multitask: executed counters differ from the prediction")
    check(out["lm"]["tokens"].shape == (serve_example.LM_BATCH, serve_example.LM_STEPS),
          f"serve_multitask: generated {out['lm']['tokens'].shape}")
    check(device.type != "cuda" or launches["flash_attention"] == lm_cfg.num_layers,
          f"serve_multitask: launches {launches}")
    row = {"audio": out["audio"], "session": out["session"], "adaptive": out["adaptive"],
           "lm_seconds": out["lm"]["seconds"], "tokens_row0": out["lm"]["tokens"][0].tolist(),
           "launches": launches}
    print(json.dumps({"serve_multitask": row}), flush=True)
    return row


def pearson_guard_phase(device: torch.device) -> dict:
    """Pearson has no backward kernel (the reference never differentiates
    it): on the card, with grad enabled and an input that requires grad,
    the wrapper raises; without grad it runs."""
    rng = np.random.default_rng(5)
    z = ops.standardize_rows(_randn(rng, (16, 64), torch.float32, device)).requires_grad_(True)
    raised = []
    try:
        pearson_dissimilarity(z)
    except NotImplementedError as err:
        raised.append(str(err))
    check(len(raised) == 1, "Pearson under grad on the card did not raise")
    check(pearson_dissimilarity(z.detach()).shape == (16, 16), "Pearson without grad")
    row = {"pearson_guard": {"raised": len(raised), "message": raised[0]}}
    print(json.dumps(row), flush=True)
    return row


# --------------------------------------------------------------------------
# The mesh: sharded serving on a (1, 1) DeviceMesh
# --------------------------------------------------------------------------

# The LM mesh phase on a (1, 1) mesh: serving (arch, layers (None: all),
# batch, prompt, steps, policies) and training (arch, layers, batch, seq,
# steps, policy), each run off the mesh and then on it.
LM_MESH_SERVE = (
    ("mistral-nemo-12b", 8, 4, 512, 16, ("tp", "fsdp_tp")),
    ("qwen2-moe-a2.7b", None, 4, 512, 8, ("expert_tp", "fsdp_expert")),
    ("mamba2-780m", None, 4, 2048, 8, ("tp",)),
)
LM_MESH_TRAIN = (
    ("mistral-nemo-12b", 8, 4, 512, 3, "fsdp_tp"),
    ("mamba2-780m", None, 4, 2048, 2, "tp"),
)
LM_MESH_TOL = 5e-2  # prefill logits on vs off the mesh, of the largest |logit|
MESH_POLICIES = ("tp", "fsdp_tp")
# The first group's two sharded attempts fault at dispatch; the ladder's
# "single_device" rung serves it off the mesh.
MESH_FAULTS = {"dispatch": {0, 1}}
MESH_REPS = 5


def mesh_recipe(engine, requests, build, hw, tol: float, label: str) -> dict:
    """What ``mesh_phase`` needs to serve an engine's trace again once the
    engine is gone: a function rebuilding its program (the same seed, so
    the same weights), its task order, hardware model and requests."""
    return {"build": build, "order": engine.order, "hw": hw, "requests": requests,
            "tol": tol, "label": label}


def mesh_session(engine, requests, device, retry=None) -> dict:
    """A one-shot session over ``requests`` (greedy admission), launch
    counts set to 0 just before and read just after."""
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    session = engine.session(retry=retry) if retry is not None else engine.session()
    futures = [session.submit(r) for r in requests]
    session.drain()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    for f in futures:
        check(f.error() is None, f"mesh session request {f.seq} failed: {f.error()!r}")
    return {"session": session, "responses": [f.result() for f in futures],
            "seconds": seconds, "launches": launches}


def mesh_outputs_err(got, want, tol: float, label: str) -> float:
    """Max abs difference of two sessions' outputs, request for request."""
    err = 0.0
    for a, b in zip(got, want):
        check(set(a.outputs) == set(b.outputs), f"{label}task sets differ")
        for t, y in a.outputs.items():
            check(bool(torch.isfinite(y).all()), f"{label}non-finite output")
            err = max(err, float((y.float() - b.outputs[t].float()).abs().max()))
    check(err <= tol, f"{label}mesh vs off-mesh max abs err {err}")
    return err


def mesh_group_times(engine, requests, device, reps: int = MESH_REPS) -> dict:
    """Per planned group: device-clock ms of ``_execute_group`` (CUDA
    events, back to back) and host ms per suffix dispatch; the largest
    group's device breakdown (busy share, top device operations)."""
    plan = engine.plan_groups(requests)
    rows = []
    for g in plan:
        run = lambda g=g: engine._execute_group(g)  # noqa: E731
        rows.append({"valid": g.valid, "dispatches": len(engine.group_order(g)),
                     "ms": cuda_ms(run, reps=reps, warmup=1),
                     "host_ms_per_dispatch": host_ms(run, reps=reps, warmup=1)
                     / len(engine.group_order(g))})
    i = max(range(len(plan)), key=lambda j: rows[j]["dispatches"] * plan[j].xs.shape[0])
    trace = device_breakdown(lambda: engine._execute_group(plan[i]), rows[i]["ms"])
    return {"groups": rows, "ms": sum(r["ms"] for r in rows),
            "host_ms_per_dispatch": statistics.mean(r["host_ms_per_dispatch"] for r in rows),
            "largest_group": i, "trace": trace}


def mesh_timing(times, off_times) -> dict:
    """The ``mesh`` line's timings: group ms on the mesh and off it, host ms
    per dispatch, the largest group's device ms, busy share and top device
    operations (nothing on the CPU)."""
    if times is None:
        return {}
    return {
        "groups": len(times["groups"]),
        "group_ms": {"mesh": times["ms"], "off": off_times["ms"]},
        "group_ms_ratio": times["ms"] / off_times["ms"],
        "host_ms_per_dispatch": {"mesh": times["host_ms_per_dispatch"],
                                 "off": off_times["host_ms_per_dispatch"]},
        "largest_group_device_ms": {"mesh": times["trace"]["device_ms"],
                                    "off": off_times["trace"]["device_ms"]},
        "busy": {"mesh": times["trace"]["busy"], "off": off_times["trace"]["busy"]},
        "top": {"mesh": times["trace"]["top"], "off": off_times["trace"]["top"]},
    }


def mesh_engine_phase(device: torch.device, mesh, recipe: dict) -> list:
    """One engine's trace off the mesh and on it under each policy."""
    from repro_torch.sharding.policy import POLICIES as SHARDING_POLICIES

    label, tol, requests = f"mesh {recipe['label']} ", recipe["tol"], recipe["requests"]
    program = recipe["build"]()
    off = MultitaskEngine(program, hw=recipe["hw"], order=recipe["order"])
    off_run = mesh_session(off, requests, device)
    off_stats = off_run["session"]
    check(off_stats.stats == off_stats.predicted, f"{label}off-mesh counters")
    # Timed on the card only (CUDA events).
    off_times = mesh_group_times(off, requests, device) if device.type == "cuda" else None
    rows = []
    for name in MESH_POLICIES:
        t0 = time.perf_counter()
        eng = MultitaskEngine(program, hw=recipe["hw"], order=recipe["order"],
                              policy=EnginePolicy(mesh=mesh, sharding=SHARDING_POLICIES[name]))
        check(eng.data_shards == 1 and eng.weight_shards == 1, f"{label}{name}: shard counts")
        # Measure every dispatch's collectives (one calibration run each)
        # before the launch counts are set to 0.
        eng.predicted_group_stats(eng.plan_groups(requests))
        run = mesh_session(eng, requests, device)
        session = run["session"]
        check(session.stats == session.predicted,
              f"{label}{name}: counters {session.stats} != predicted {session.predicted}")
        check(session.stats.collective_bytes == 0,
              f"{label}{name}: {session.stats.collective_bytes} collective bytes on one device")
        check(all(r.degraded is None for r in run["responses"]), f"{label}{name}: degraded")
        check(run["launches"] == off_run["launches"],
              f"{label}{name}: launches {run['launches']} != off the mesh {off_run['launches']}")
        err = mesh_outputs_err(run["responses"], off_run["responses"], tol, f"{label}{name}: ")
        times = mesh_group_times(eng, requests, device) if off_times else None
        # The ladder: a group that fails twice on the mesh is served off it.
        eng.fault_injector = FaultInjector(script=MESH_FAULTS, max_faults=2)
        faulted = mesh_session(eng, requests, device,
                               retry=RetryPolicy(max_retries=1, degrade=True))
        eng.fault_injector = None
        fs = faulted["session"]
        rungs = [r.degraded for r in faulted["responses"]]
        check(fs.degraded_runs == 1 and fs.groups_failed == 0,
              f"{label}{name}: degraded runs {fs.degraded_runs}, failed {fs.groups_failed}")
        check(set(rungs) == {"single_device", None} and rungs.count("single_device") >= 1,
              f"{label}{name}: rungs {rungs}")
        check(fs.stats == fs.predicted, f"{label}{name}: faulted counters")
        check(fs.stats.collective_bytes == 0, f"{label}{name}: faulted collective bytes")
        check(faulted["launches"] == off_run["launches"],
              f"{label}{name}: faulted launches {faulted['launches']}")
        fault_err = mesh_outputs_err(faulted["responses"], off_run["responses"], tol,
                                     f"{label}{name} faulted: ")
        row = {
            "engine": recipe["label"], "policy": name, "mesh": [1, 1],
            "requests": len(requests),
            "session_s": {"mesh": run["seconds"], "off": off_run["seconds"]},
            **mesh_timing(times, off_times),
            "launches": run["launches"], "calibrations": eng.executor.calibrations,
            "collective_bytes": session.stats.collective_bytes,
            "max_abs_err": err, "faulted": {"rungs": rungs.count("single_device"),
                                            "max_abs_err": fault_err},
            "phase_s": time.perf_counter() - t0,
        }
        print(json.dumps({"mesh": row}), flush=True)
        rows.append(row)
        del eng, run, faulted
        free_memory()
    return rows


def mesh_phase(device: torch.device, recipes) -> dict:
    """Mesh-sharded serving on a (1, 1) ``DeviceMesh``: a world of one rank
    (NCCL on the card, gloo on the CPU, a ``FileStore`` in a temporary
    directory), each recipe's trace served off the mesh and then on it under
    ``TP_POLICY`` and ``FSDP_TP_POLICY``.  One device issues no collective,
    so the phase proves the placement, the kernels on local shards (as many
    launches as off the mesh), the exact counters and the
    ``single_device`` rung; the process group is destroyed before it
    returns."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device=device.type)
            for recipe in recipes:
                out[recipe["label"]] = mesh_engine_phase(device, mesh, recipe)
                free_memory()
        finally:
            dist.destroy_process_group()
    return out


def lm_serve_run(device: torch.device, model, params, prompts, steps: int,
                 policy=None) -> dict:
    """One ``LMServer.generate`` (off the mesh where ``policy`` is None, else
    on the ambient mesh that ``params`` lie on) with its launches, seconds,
    tokens/s and peak memory; then one prefill and one decode step under
    the ``CollectiveRecorder``, the prefill's last-position logits, and on
    the card the prefill's and a decode step's device ms, a decode step's
    host ms and the device's busy share over it."""
    args = () if policy is None else (policy,)
    server = LMServer(model, params, *args)
    s0 = prompts.shape[1]
    reset_peak(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    tokens = server.generate(prompts, steps)
    sync(device)
    seconds = time.perf_counter() - t0
    launches, peak = launch_counts(), peak_gb(device)
    with CollectiveRecorder() as rec:
        logits, cache = model.prefill(params, prompts, *args)
        cache = _grow_cache(model, cache, s0 + steps, s0, *args)
        tok = greedy(logits)
        model.decode_step(params, tok, cache, s0, *args)
    sync(device)
    logits = logits.full_tensor() if is_dtensor(logits) else logits
    out = {"tokens": tokens, "launches": launches, "generate_s": seconds,
           "tokens_per_s": tokens.size / seconds, "peak_gb": peak,
           "collective_bytes": sum(rec.bytes.values()), "collectives": rec.counts,
           "logits": logits.float()}
    if device.type == "cuda":
        prefill = lambda: model.prefill(params, prompts, *args)  # noqa: E731
        decode = lambda: model.decode_step(params, tok, cache, s0, *args)  # noqa: E731
        out["prefill_ms"] = cuda_ms(prefill, reps=2, warmup=1)
        out["decode_ms"] = cuda_ms(decode, reps=3, warmup=1)
        out["decode_host_ms"] = host_ms(decode, reps=3, warmup=0)
        out["busy"] = device_breakdown(decode, out["decode_ms"], top=4, warm=False)["busy"]
    return out


def lm_train_run(device: torch.device, model, params, batches, steps: int,
                 policy=None) -> dict:
    """``steps`` AdamW steps (lr 3e-4, warmup 1) from ``params`` (off the
    mesh where ``policy`` is None, else on it), the first under the
    ``CollectiveRecorder`` and untimed, the rest timed on the host clock to
    a sync; the losses, grad norms, launches, step ms and peak memory."""
    args = () if policy is None else (policy,)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps),
                              *args)
    reset_launch_counts()
    reset_peak(device)
    losses, gnorms, step_ms = [], [], []
    rec = CollectiveRecorder()
    for i, tokens in enumerate(batches[:steps]):
        t0 = time.perf_counter()
        with rec if i == 0 else contextlib.nullcontext():
            params, opt, metrics = step_fn(params, opt, tokens)
        sync(device)
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    out = {"losses": losses, "grad_norms": gnorms, "launches": launch_counts(),
           "step_ms": step_ms, "steady_step_ms": statistics.median(step_ms),
           "peak_gb": peak_gb(device), "collective_bytes": sum(rec.bytes.values()),
           "collectives": rec.counts}
    del params, opt
    free_memory()
    return out


def lm_mesh_phase(device: torch.device, smi: str, serve=LM_MESH_SERVE,
                  train=LM_MESH_TRAIN, config=get_config) -> dict:
    """LM serving and training on a (1, 1) ``DeviceMesh`` (a world of one,
    NCCL on the card, gloo on the CPU, made and ended by
    ``launch.mesh.launcher_world``): each run off the mesh and then on it
    from the same params, placed by ``fit_specs(params,
    param_specs(policy), mesh)``.  Gates: the same tokens; prefill logits
    within ``LM_MESH_TOL`` of the largest |logit|; losses and grad norms
    within ``TRAIN_LOSS_TOL``; the same flash and SSD launches, forward and
    backward (the kernels run on each rank's local shards); no collective
    bytes.  Prints one ``lm_mesh`` line a run, with ``smi`` (the card's name
    and power limit)."""
    from repro_torch.launch.mesh import launcher_world, make_host_mesh, set_mesh
    from repro_torch.sharding.policy import POLICIES as SHARDING_POLICIES
    from repro_torch.sharding.utils import place_tree

    keys = ("prefill_ms", "decode_ms", "decode_host_ms", "tokens_per_s", "busy", "peak_gb",
            "generate_s")
    rows, launches = [], {}
    gen_device = device if device.type == "cuda" else torch.device("cpu")
    with launcher_world(device.type):
        mesh = make_host_mesh(device=device.type)
        for arch, layers, batch, prompt, steps, policies in serve:
            cfg = config(arch)
            cfg = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
            model = get_model(cfg)
            params = model.init(torch.Generator(device=gen_device).manual_seed(2), device)
            prompts = np.random.default_rng(2).integers(
                0, cfg.raw_vocab_size, (batch, prompt)).astype(np.int32)
            off = lm_serve_run(device, model, params, prompts, steps)
            for name in policies:
                t0 = time.perf_counter()
                policy = SHARDING_POLICIES[name]
                with set_mesh(mesh):
                    on = lm_serve_run(device, model, place_tree(
                        params, model.param_specs(policy), mesh), prompts, steps, policy)
                label = f"lm_mesh {arch} {name}"
                check(np.array_equal(on["tokens"], off["tokens"]), f"{label}: tokens differ")
                diff = float((on["logits"] - off["logits"]).abs().max())
                scale = float(off["logits"].abs().max())
                check(diff <= LM_MESH_TOL * scale,
                      f"{label}: prefill logits differ by {diff} > {LM_MESH_TOL} x {scale}")
                check(on["launches"] == off["launches"],
                      f"{label}: launches {on['launches']} != off the mesh {off['launches']}")
                check(on["collective_bytes"] == 0,
                      f"{label}: {on['collective_bytes']} collective bytes on one device")
                row = {"kind": "serve", "arch": arch, "policy": name, "mesh": [1, 1],
                       "layers": cfg.num_layers, "batch": batch, "prompt": prompt,
                       "steps": steps, "card": smi, "logit_max_abs_diff": diff,
                       "max_abs_logit": scale, "launches": on["launches"],
                       "collectives": on["collectives"],
                       **{k: {"mesh": on.get(k), "off": off.get(k)} for k in keys},
                       "phase_s": time.perf_counter() - t0}
                print(json.dumps({"lm_mesh": row}), flush=True)
                rows.append(row)
                launches[f"lm_mesh_{arch}_{name}"] = on["launches"]
            del model, params, off, on
            free_memory()
        for arch, layers, batch, seq, steps, name in train:
            t0 = time.perf_counter()
            cfg = config(arch)
            cfg = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
            model = get_model(cfg)
            params = model.init(torch.Generator(device=gen_device).manual_seed(0), device)
            it = lm_batches(cfg.vocab_size, batch, seq, seed=0)
            batches = [next(it) for _ in range(steps)]
            off = lm_train_run(device, model, params, batches, steps)
            policy = SHARDING_POLICIES[name]
            with set_mesh(mesh):
                on = lm_train_run(device, model, place_tree(
                    params, model.param_specs(policy), mesh), batches, steps, policy)
            label = f"lm_mesh train {arch} {name}"
            worst = max(max(rel(a, b) for a, b in zip(on["losses"], off["losses"])),
                        max(rel(a, b) for a, b in zip(on["grad_norms"], off["grad_norms"])))
            check(worst <= TRAIN_LOSS_TOL,
                  f"{label}: losses {on['losses']} vs {off['losses']}, grad norms "
                  f"{on['grad_norms']} vs {off['grad_norms']}, > {TRAIN_LOSS_TOL} relative")
            check(on["launches"] == off["launches"],
                  f"{label}: launches {on['launches']} != off the mesh {off['launches']}")
            check(on["collective_bytes"] == 0,
                  f"{label}: {on['collective_bytes']} collective bytes on one device")
            row = {"kind": "train", "arch": arch, "policy": name, "mesh": [1, 1],
                   "layers": cfg.num_layers, "remat": cfg.remat, "batch": batch, "seq": seq,
                   "steps": steps, "card": smi, "max_rel_diff": worst,
                   "losses": {"mesh": on["losses"], "off": off["losses"]},
                   "grad_norms": {"mesh": on["grad_norms"], "off": off["grad_norms"]},
                   "launches": on["launches"], "collectives": on["collectives"],
                   **{k: {"mesh": on[k], "off": off[k]}
                      for k in ("steady_step_ms", "step_ms", "peak_gb")},
                   "phase_s": time.perf_counter() - t0}
            print(json.dumps({"lm_mesh": row}), flush=True)
            rows.append(row)
            launches[f"lm_mesh_train_{arch}_{name}"] = on["launches"]
            del model, params, off, on
            free_memory()
    return {"rows": rows, "launches": launches}


# --------------------------------------------------------------------------
# A sharded mesh with values: 8 gloo ranks on the host's CPU
# --------------------------------------------------------------------------

# A (2, 4) ``(data, model)`` mesh: mistral's 2 KV heads and granite-34b's one
# do not divide the 4-way model axis, so ranks that split the query heads
# share a KV head; mamba2 splits its SSD heads and gathers B and C.
GLOO_RANKS = 8
GLOO_MESH = (2, 4)
GLOO_CASES = (("mistral-nemo-12b", "train"), ("mamba2-780m", "train"),
              ("granite-34b", "prefill"))
GLOO_BATCH, GLOO_SEQ = 8, 64
GLOO_SECONDS = 120        # the hard limit on the world (it takes well under 60 s)
GLOO_LOSS_TOL = 2e-5      # the loss, relative
GLOO_GRAD_TOL = 1e-4      # each gradient leaf, of its largest |value|
GLOO_LOGITS_TOL = 1e-5    # the prefill logits, of max(1, their largest |value|)


def gloo_rank(rank: int, workdir: str) -> int:
    """One rank of :func:`gloo_mesh_phase`'s world (``python chip_smoke.py
    --gloo-rank RANK DIR``): join the gloo world through a ``FileStore`` in
    ``DIR``, run every case of :data:`GLOO_CASES` on the mesh and off it
    from the same smoke weights (one seed on every rank), and write the
    errors (rank 0) to ``DIR/gloo.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.sharding.policy import TP_POLICY
    from repro_torch.sharding.utils import place_tree
    from repro_torch.training import loss_and_grads

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), GLOO_RANKS), rank=rank,
        world_size=GLOO_RANKS, timeout=datetime.timedelta(seconds=GLOO_SECONDS))
    try:
        mesh = make_mesh(GLOO_MESH, ("data", "model"), device="cpu")
        rows = {}
        for arch, kind in GLOO_CASES:
            t0 = time.perf_counter()
            cfg = get_smoke_config(arch)
            model = get_model(cfg)
            params = model.init(torch.Generator().manual_seed(0), torch.device("cpu"))
            tokens = np.random.default_rng(3).integers(
                0, cfg.raw_vocab_size, (GLOO_BATCH, GLOO_SEQ)).astype(np.int32)
            with set_mesh(mesh):
                placed = place_tree(params, model.param_specs(TP_POLICY), mesh)
                if kind == "train":
                    loss, _, grads = loss_and_grads(model, placed, tokens, 1, TP_POLICY)
                    on = [loss] + [g.full_tensor() for g in tree_leaves(grads)]
                else:
                    on = [model.prefill(placed, tokens, TP_POLICY)[0].full_tensor()]
            if kind == "train":
                loss, _, grads = loss_and_grads(model, params, tokens)
                off = [loss] + tree_leaves(grads)
                row = {"loss": float(off[0]),
                       "loss_rel_err": abs(float(on[0]) - float(off[0])) / abs(float(off[0])),
                       "grad_rel_err": max(
                           float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
                           for a, b in zip(on[1:], off[1:])),
                       "leaves": len(off) - 1}
            else:
                want = model.prefill(params, tokens)[0]
                row = {"logits_rel_err": float((on[0] - want).abs().max())
                       / max(1.0, float(want.abs().max()))}
            row["seconds"] = time.perf_counter() - t0
            rows[f"{arch}/{kind}"] = row
        if rank == 0:
            with open(os.path.join(workdir, "gloo.json"), "w") as fh:
                json.dump(rows, fh)
    finally:
        dist.destroy_process_group()
    return 0


def gloo_mesh_phase(smi: str) -> dict:
    """A sharded mesh with values on the host's torch: 8 gloo ranks on the
    CPU (one subprocess each, no card, no JAX) on a (2, 4) ``(data, model)``
    mesh, :func:`gloo_rank`.  Gates: a smoke mistral-nemo-12b and a smoke
    mamba2-780m train step (loss within ``GLOO_LOSS_TOL``, every gradient
    leaf within ``GLOO_GRAD_TOL`` of its largest |value|) and a smoke
    granite-34b prefill (logits within ``GLOO_LOGITS_TOL``) agree with the
    same code off the mesh.  Prints the ``gloo_mesh`` line."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as wd:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gloo-rank", str(r), wd],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(GLOO_RANKS)]
        try:
            logs = [p.communicate(timeout=GLOO_SECONDS)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"gloo rank {r}: rc {p.returncode}: {log[-3000:]}")
        with open(os.path.join(wd, "gloo.json")) as fh:
            rows = json.load(fh)
    for name, row in rows.items():
        if "loss_rel_err" in row:
            check(row["loss_rel_err"] <= GLOO_LOSS_TOL and row["grad_rel_err"] <= GLOO_GRAD_TOL,
                  f"gloo mesh {name}: loss {row['loss_rel_err']:.3g}, grads "
                  f"{row['grad_rel_err']:.3g} off the mesh's")
        else:
            check(row["logits_rel_err"] <= GLOO_LOGITS_TOL,
                  f"gloo mesh {name}: logits {row['logits_rel_err']:.3g} off the mesh's")
    line = {"device": smi, "torch": torch.__version__, "ranks": GLOO_RANKS,
            "mesh": "x".join(map(str, GLOO_MESH)), "cases": rows,
            "phase_s": time.perf_counter() - t0}
    print(json.dumps({"gloo_mesh": line}), flush=True)
    return line


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
    flash_bwd = flash_bwd_phase(device)
    ssd = ssd_phase(device)
    ssd_bwd = ssd_bwd_phase(device)
    print(json.dumps({"kernel_checks_seconds": time.perf_counter() - t0}), flush=True)

    # LeNet-5: profile -> select -> order -> serve.
    reset_launch_counts()
    result = pipeline_phase(device)
    lenet_launches = launch_counts()
    # The mesh phase serves this trace again at the end, from a rebuilt
    # program (the same seed: the same weights).
    mesh_recipes = [mesh_recipe(
        result["engine"], result["requests"],
        lambda g=result["engine"].program.graph: build_cnn_program(
            g, [N_CLASSES] * N_TASKS, generator=torch.Generator().manual_seed(1),
            device=device),
        MSP430, PIPELINE_TOL, "lenet")]
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
    # Kept for the adaptive phase's LeNet-5 gate.
    lenet = (result["engine"], result["requests"], lenet_clean["responses"])
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
    mesh_recipes.append(mesh_recipe(
        tf["engine"], tf["requests"],
        lambda g=tf["engine"].program.graph, c=cfg: build_transformer_program(
            g, c, [N_CLASSES] * N_TASKS, TF_SEQ,
            generator=torch.Generator(device=device).manual_seed(1), device=device),
        TPU_V5E, TF_TOL, ARCH))
    # The same engine and requests through sessions, then scripted faults.
    t0 = time.perf_counter()
    tf_sessions = session_phase(tf["engine"], tf["requests"], device, TF_TOL,
                                f"{ARCH} ", layers_per_block)
    tf_chaos = chaos_phase(tf["engine"], tf["requests"], tf_sessions["window"]["responses"],
                           device, TF_TOL, f"{ARCH} ")
    print(json.dumps({"transformer_session_seconds": time.perf_counter() - t0}), flush=True)
    session_flash = {name: v["row"]["launches"]["flash_attention"]
                     for name, v in tf_sessions.items()}
    # Input-adaptive gating on the same program and trace (and LeNet-5's).
    t0 = time.perf_counter()
    tf_adaptive = adaptive_phase(tf["engine"], tf["requests"], tf_sessions["window"], lenet,
                                 device, TF_TOL, f"{ARCH} ", layers_per_block)
    adaptive_flash = {f"transformer_adaptive_{name}": n
                      for name, n in tf_adaptive["flash"].items()}
    del lenet
    print(json.dumps({"adaptive_phase_seconds": time.perf_counter() - t0}), flush=True)
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

    # Training: mistral-nemo-12b (8 layers) through the flash backward, the
    # train launcher on whisper-medium; mamba2-780m and zamba2-2.7b at full
    # depth through the SSD backward, the train launcher on mamba2-780m; the
    # two examples; Pearson's guard.
    t0 = time.perf_counter()
    train = train_phase(device)
    train_launch = train_launcher_phase(*TRAIN_LAUNCHER)
    print(json.dumps({"train_launcher": train_launch}), flush=True)
    free_memory()
    train_ssm = {}
    for arch, batch, seq, steps in TRAIN_SSMS:
        t1 = time.perf_counter()
        train_ssm[arch] = train_ssm_phase(device, get_config(arch), batch, seq, steps,
                                          count=arch == DRYRUN_COUNTED_SSM)
        print(json.dumps({"train_ssm_phase_seconds": {arch: time.perf_counter() - t1}}),
              flush=True)
    ssm_launch = train_launcher_phase(*TRAIN_SSM_LAUNCHER)
    print(json.dumps({"train_launcher": ssm_launch}), flush=True)
    free_memory()
    t1 = time.perf_counter()
    multitask = train_multitask_phase(device, *TRAIN_MULTITASK)
    serve_mt = serve_multitask_phase(device)
    print(json.dumps({"example_phases_seconds": time.perf_counter() - t1}), flush=True)
    pearson_guard_phase(device)
    print(json.dumps({"training_phases_seconds": time.perf_counter() - t0}), flush=True)

    # The launch analysis: the dry run on three full configs, and the train
    # steps counted on the card and on meta.
    dryrun_phase(smi, {f"{ARCH} ({TRAIN_LAYERS} layers)": train["counted"],
                       DRYRUN_COUNTED_SSM: train_ssm[DRYRUN_COUNTED_SSM]["counted"]})

    # Mesh-sharded serving of the LeNet-5 and mistral-nemo-12b traces on a
    # (1, 1) mesh under both policies.
    t0 = time.perf_counter()
    mesh = mesh_phase(device, mesh_recipes)
    mesh_flash = {f"mesh_{label}_{row['policy']}": row["launches"]["flash_attention"]
                  for label, rows in mesh.items() for row in rows}
    print(json.dumps({"mesh_phase_seconds": time.perf_counter() - t0}), flush=True)
    # LM serving and training on a (1, 1) mesh: mistral-nemo-12b, qwen2-moe
    # and mamba2-780m, each off the mesh and then on it.
    t0 = time.perf_counter()
    lm_mesh = lm_mesh_phase(device, smi)
    lm_mesh_by = {name: {path: n[name] for path, n in lm_mesh["launches"].items()}
                  for name in ("flash_attention", "flash_attention_bwd", "ssd_scan",
                               "ssd_scan_bwd")}
    print(json.dumps({"lm_mesh_phase_seconds": time.perf_counter() - t0}), flush=True)
    gloo_mesh_phase(smi)
    print(json.dumps({"smoke_seconds": time.perf_counter() - t_start}), flush=True)

    pearson_row = kernels["rows"][0]
    transformer_pearson_row = next(r for r in kernels["rows"] if r["K"] == TF_PROBES)
    moe_pearson_row = next(r for r in kernels["rows"]
                           if (r["K"], r["F"]) == (TF_PROBES, TF_SEQ * moe_cfg.d_model))
    family_flash = {f"{arch}_prefill": family[arch]["launches"]["flash_attention"]
                    for arch in family}
    flash_row = flash["rows"][0]
    ssd_main = [r for r in ssd["rows"] if r["path"] in ("mamba2_prefill", "zamba2_prefill")]
    train_flash = {f"train_{k}": v["flash_attention"] for k, v in train["launches"].items()}
    train_flash["whisper_train_launcher"] = train_launch["launches"]["flash_attention"]
    train_flash["zamba2_train_steps"] = train_ssm["zamba2-2.7b"]["launches"]["steps"][
        "flash_attention"]
    train_flash["train_multitask"] = multitask["launches"]["flash_attention"]
    train_flash["serve_multitask_prefill"] = serve_mt["launches"]["flash_attention"]
    train_bwd = {f"train_{k}": v["flash_attention_bwd"] for k, v in train["launches"].items()}
    train_bwd["whisper_train_launcher"] = train_launch["launches"]["flash_attention_bwd"]
    train_bwd["zamba2_train_steps"] = train_ssm["zamba2-2.7b"]["launches"]["steps"][
        "flash_attention_bwd"]
    train_bwd["train_multitask"] = multitask["launches"]["flash_attention_bwd"]
    ssd_train = {f"{arch.split('-')[0]}_train_{k}": v["ssd_scan"]
                 for arch, row in train_ssm.items() for k, v in row["launches"].items()}
    ssd_train["mamba2_train_launcher"] = ssm_launch["launches"]["ssd_scan"]
    ssd_bwd_by_path = {f"{arch.split('-')[0]}_train_{k}": v["ssd_scan_bwd"]
                       for arch, row in train_ssm.items() for k, v in row["launches"].items()}
    ssd_bwd_by_path["mamba2_train_launcher"] = ssm_launch["launches"]["ssd_scan_bwd"]
    ssd_bwd_row = next(r for r in ssd_bwd["rows"]
                       if r["path"] == "mamba2_train" and r["dtype"] == "bfloat16")
    bwd_row = next(r for r in flash_bwd["rows"]
                   if r["path"] == "train" and r["dtype"] == "bfloat16")
    ssd_by_path = {"mamba2_prefill": mamba["launches"]["ssd_scan"],
                   "zamba2_prefill": zamba["launches"]["ssd_scan"],
                   "launcher": launcher["launches"]["ssd_scan"], **ssd_train}
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
                     + sum(stream_flash.values()) + sum(adaptive_flash.values())
                     + batcher_flash
                     + lm["launches"]["flash_attention"] + zamba["launches"]["flash_attention"]
                     + moe_prof["flash_attention"] + moe_serve["flash_attention"]
                     + sum(family_flash.values())
                     + launcher_whisper["launches"]["flash_attention"]
                     + sum(train_flash.values()) + sum(mesh_flash.values())
                     + sum(lm_mesh_by["flash_attention"].values())),
        "launches_by_path": {"transformer_profile": prof["flash_attention"],
                             "transformer_serve": serve["flash_attention"],
                             **{f"transformer_session_{name}": n
                                for name, n in session_flash.items()},
                             "transformer_session_chaos": tf_chaos["launches"]["flash_attention"],
                             **stream_flash,
                             **adaptive_flash,
                             "batcher_prefill": batcher_flash,
                             "lm_prefill": lm["launches"]["flash_attention"],
                             "zamba2_prefill": zamba["launches"]["flash_attention"],
                             "moe_profile": moe_prof["flash_attention"],
                             "moe_serve": moe_serve["flash_attention"],
                             **family_flash,
                             "whisper_launcher": launcher_whisper["launches"]["flash_attention"],
                             **train_flash, **mesh_flash,
                             **lm_mesh_by["flash_attention"]},
        "max_abs_err": flash["max_abs_err"],
        "ms": flash_row["kernel_ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
        "shape": flash_row["shape"],
        "by_path": {r["path"]: {k: r[k] for k in ("shape", *timed)} for r in flash["rows"]},
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        # No pallas_call: the reference differentiates its jnp attention
        # (attention_chunked) with XLA's autodiff.
        "replaces": "src/repro/models/layers.py:176",
        "launches": sum(train_bwd.values()) + sum(lm_mesh_by["flash_attention_bwd"].values()),
        "launches_by_path": {**train_bwd, **lm_mesh_by["flash_attention_bwd"]},
        "max_abs_err": flash_bwd["max_abs_err"],
        "max_rel_err": flash_bwd["max_rel_err"],
        "ms": bwd_row["kernel_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"],
        "shape": [bwd_row[k] for k in ("B", "S", "T", "Hq", "Hk", "d")],
        "device_kernels": list(FLASH_BWD_KERNELS[torch.bfloat16]),
        "sub_kernels": bwd_row["sub_kernels"],
        "by_path": {f"{r['path']}_{r['dtype']}": {k: r[k] for k in (*timed, "sub_kernels")}
                    for r in flash_bwd["rows"]},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:100",
        "launches": sum(ssd_by_path.values()) + sum(lm_mesh_by["ssd_scan"].values()),
        "launches_by_path": {**ssd_by_path, **lm_mesh_by["ssd_scan"]},
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd_main[0]["kernel_ms"],
        "plain_ms": ssd_main[0]["plain_ms"],
        "bound_ms": ssd_main[0]["bound_ms"],
        "bound_by": ssd_main[0]["bound_by"],
        "library_ms": None,
        "shape": ssd_main[0]["shape"],
        "by_path": {r["path"]: {k: r[k] for k in ("shape", *timed)} for r in ssd_main},
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        # No pallas_call: the reference differentiates its jnp oracle
        # ssd_chunked with XLA's autodiff.
        "replaces": "src/repro/models/ssm.py:40",
        "launches": sum(ssd_bwd_by_path.values()) + sum(lm_mesh_by["ssd_scan_bwd"].values()),
        "launches_by_path": {**ssd_bwd_by_path, **lm_mesh_by["ssd_scan_bwd"]},
        "max_abs_err": ssd_bwd["max_abs_err"],
        "max_rel_err": ssd_bwd["max_rel_err"],
        "ms": ssd_bwd_row["kernel_ms"],
        "plain_ms": ssd_bwd_row["plain_ms"],
        "bound_ms": ssd_bwd_row["bound_ms"],
        "bound_by": ssd_bwd_row["bound_by"],
        "library_ms": None,
        "shape": ssd_bwd_row["shape"],
        "device_kernels": list(SSD_BWD16_KERNELS),
        "sub_kernels": ssd_bwd_row["sub_kernels"],
        "scratch_bytes": ssd_bwd_row["scratch_bytes"],
        "by_path": {f"{r['path']}_{r['dtype']}": {k: r.get(k) for k in (
            "shape", *timed, "scratch_bytes", "sub_kernels")} for r in ssd_bwd["rows"]},
    }], "launch_counts": launch_counts()}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--gloo-rank":
        sys.exit(gloo_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
