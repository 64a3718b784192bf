"""Roofline terms of a step and the work of each hand kernel, the PyTorch
port of ``repro.launch.roofline``.

    compute term    = FLOPs / (chips * peak FLOP/s)
    memory term     = bytes / (chips * HBM bytes/s)
    collective term = collective bytes / link bytes/s

The reference reads FLOPs and bytes from a compiled HLO module and parses
the collectives out of its text (``collective_bytes(hlo_text)``).  Eager
PyTorch has no HLO: :func:`repro_torch.launch.op_cost.analyze_step` counts
FLOPs and bytes over the aten ops a step runs on this rank's shards, and
the collective bytes come from
:class:`~repro_torch.sharding.collectives.CollectiveRecorder`'s per-kind
breakdown (:func:`collective_totals`).

The constants are one NVIDIA H100 SXM5's (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s of HBM3.  The
reference's are a TPU v5e's, not used here.

The kernel formulas (:func:`pearson_work`, :func:`flash_work`,
:func:`flash_bwd_work`, :func:`ssd_work`, :func:`ssd_bwd_work`) give the
operations and bytes of one call of each hand kernel from its shapes and
dtype: each input read once, each output written once, operations counted
over the work these inputs need (the causal and window masks' kept pairs,
the SSD's causal pairs within a chunk).  ``PERF.md`` §6's bound column and
``chip_smoke.py``'s kernel rows read them, and each kernel wrapper reports
its formula to an active :class:`~repro_torch.launch.op_cost.OpCounter`
once per launch, whichever route runs it (the CUDA kernel, the plain
version on the CPU, a meta shape run).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

#: Dense bf16 on the tensor cores, the peak a step's FLOPs are held to.
PEAK_FLOPS = 989e12
#: fp32 on the CUDA cores (the fp32 kernels; TF32 is off).
FP32_PEAK_FLOPS = 67e12
HBM_BW = 3.35e12
#: NVLink 4 on the H100 SXM5: 900 GB/s per GPU counting both directions
#: (NVIDIA H100 data sheet), so 450 GB/s each way.  The collective term
#: divides each rank's result bytes, which it receives, by the one-way rate.
LINK_BW = 450e9

#: The reference's collective kinds (``hlo_cost.COLLECTIVE_KINDS``).
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

Work = Dict[str, float]


def collective_totals(breakdown: Mapping[str, float]) -> Dict[str, float]:
    """A :class:`~repro_torch.sharding.collectives.CollectiveRecorder`
    breakdown as the reference's ``collective_bytes`` dict: every kind
    (0 where none ran, ``other`` kept where it ran) and ``total``."""
    totals = {k: float(breakdown.get(k, 0.0)) for k in COLLECTIVE_KINDS}
    totals.update({k: float(v) for k, v in breakdown.items() if k not in totals})
    totals["total"] = float(sum(totals.values()))
    return totals


@dataclasses.dataclass
class RooflineReport:
    """The reference's report.  ``hlo_flops`` and ``hlo_bytes`` keep their
    names (the dry run's JSON keys): here they are the counted aten and
    kernel FLOPs and bytes of every rank together (one rank's times
    ``chips``), and ``coll_bytes`` one rank's collective result bytes."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, float]
    model_flops: float
    bytes_per_device: float
    peak_memory_per_device: float

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # Collective bytes are already one rank's traffic.
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "bytes_per_device": self.bytes_per_device,
            "peak_memory_per_device": self.peak_memory_per_device,
        }


def model_flops_estimate(cfg, shape, n_params: int, n_active: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference) with N = active params.

    D is tokens processed: B*S for train/prefill, B for one decode step.
    """
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def active_params(cfg, n_params: int) -> int:
    """MoE: only top-k (+ shared) experts are active per token."""
    if cfg.moe_num_experts <= 0:
        return n_params
    f, d, e = cfg.moe_d_ff, cfg.d_model, cfg.moe_num_experts
    per_expert = 3 * d * f
    routed_total = cfg.num_layers * e * per_expert
    routed_active = cfg.num_layers * cfg.moe_top_k * per_expert
    return n_params - routed_total + routed_active


def step_mfu(model_flops: float, step_s: float) -> float:
    """``mfu``: a step's model FLOPs per second over the bf16 peak."""
    return model_flops / step_s / PEAK_FLOPS


def roofline_share(flops: float, nbytes: float, step_s: float) -> float:
    """``roofline_share``: the least time of one device's counted work, the
    larger of its FLOPs over the bf16 peak and its bytes over HBM, as a share
    of the measured step time (above 1 only if a count is too high)."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW) / step_s


def allowed_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs the masks keep: query ``i`` of ``s`` sees key ``j``
    of ``t`` when ``j <= i`` (causal) and ``i - j < window`` (a window),
    positions being indices."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(s, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one dense-transformer training step, remat's recompute
    not counted: 6 per weight of every matrix product per token (Q, K, V and
    O projections, the SwiGLU MLP, the unembedding; the embedding is a
    gather) and 12 * d per kept query-key pair per query head and layer
    (Q K^T and P V, forward and twice in the backward)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + 3 * d * cfg.d_ff
    weights = cfg.num_layers * per_layer + d * cfg.vocab_size
    pairs = allowed_pairs(seq, seq, True, cfg.sliding_window)
    return (6.0 * weights * batch * seq
            + 12.0 * cfg.num_layers * batch * cfg.n_heads * pairs * hd)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def peak_flops(dtype: torch.dtype) -> float:
    """The peak of a kernel's input type: bf16 on the tensor cores, anything
    else on the CUDA cores in fp32."""
    return PEAK_FLOPS if dtype == torch.bfloat16 else FP32_PEAK_FLOPS


def bound(work: Work, dtype: torch.dtype) -> Dict[str, object]:
    """The least time of ``work`` on the card, in ms: the larger of its
    operations over the peak of ``dtype`` and its bytes over HBM, and which
    of the two bounds it."""
    ops_ms = work["flops"] / peak_flops(dtype) * 1e3
    bytes_ms = work["bytes"] / HBM_BW * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def pearson_work(k: int, f: int) -> Work:
    """``1 - Z Z^T`` of fp32 ``z`` (K, F): K (K + 1) F operations (the
    upper triangle of the symmetric product, diagonal included) against
    z read and the (K, K) output written once."""
    return {"flops": float(k * (k + 1) * f), "bytes": float(4 * (k * f + k * k))}


def flash_work(b: int, s: int, t: int, hq: int, hk: int, d: int, dtype: torch.dtype,
               causal: bool, window: Optional[int]) -> Work:
    """Flash attention of (B, S, Hq, d) queries over (B, T, Hk, d) keys and
    values: 4 B Hq pairs d operations (Q K^T and P V over the kept pairs)
    against q, k, v read and o written once (K/V not repeated).  Padded keys
    the caller passes count as keys."""
    pairs = allowed_pairs(s, t, causal, window)
    es = _itemsize(dtype)
    return {"flops": 4.0 * b * hq * pairs * d,
            "bytes": float(es * (2 * b * s * hq * d + 2 * b * t * hk * d))}


def flash_bwd_work(b: int, s: int, t: int, hq: int, hk: int, d: int, dtype: torch.dtype,
                   causal: bool, window: Optional[int]) -> Work:
    """The flash backward: 10 B Hq pairs d operations (S = Q K^T again,
    dP = dO V^T, dV, dQ, dK: five products) against q, k, v, o, dO and the
    fp32 logsumexp read once and dQ, dK, dV written once."""
    pairs = allowed_pairs(s, t, causal, window)
    es = _itemsize(dtype)
    return {"flops": 10.0 * b * hq * pairs * d,
            "bytes": float(es * (4 * b * s * hq * d + 4 * b * t * hk * d) + 4 * b * hq * s)}


def ssd_work(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype: torch.dtype) -> Work:
    """One chunked SSD: B nc [2 Qc N + H (2 Qc P + 4 Q N P)] operations
    (causal pairs only, Qc = Q (Q + 1) / 2) against x, dt, a, B, C read
    once and y and the fp32 final state written once."""
    nc, qc = -(-s // chunk), chunk * (chunk + 1) // 2
    es = _itemsize(dtype)
    return {"flops": float(b * nc * (2 * qc * n + h * (2 * qc * p + 4 * chunk * n * p))),
            "bytes": float(es * (2 * b * s * h * p + 2 * b * s * n)
                           + 4 * (b * s * h + h + b * h * p * n))}


def ssd_bwd_work(b: int, s: int, h: int, p: int, n: int, chunk: int, dtype: torch.dtype,
                 with_final: bool) -> Work:
    """One SSD backward: B nc [2 Qc N + H (4 Qc P + 4 Qc N + 10 Q N P)]
    operations (C.B and dy.x over the causal pairs, dx from the pairs, dB
    and dC from the pairs; the chunk's state, U_c, G_c B, G_c^T x and
    h_c^T dy) against x, dy, dt, a, B, C (and the final state's cotangent)
    read once and dx, ddt, da, dB, dC written once."""
    nc, qc = -(-s // chunk), chunk * (chunk + 1) // 2
    es = _itemsize(dtype)
    return {"flops": float(b * nc * (2 * qc * n + h * (4 * qc * p + 4 * qc * n
                                                       + 10 * chunk * n * p))),
            "bytes": float(es * (3 * b * s * h * p + 4 * b * s * n) + 4 * (2 * b * s * h + 2 * h)
                           + (4 * b * h * p * n if with_final else 0))}
