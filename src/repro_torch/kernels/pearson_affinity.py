"""The pairwise inverse-Pearson Gram ``1 - Z Z^T`` (paper §3.1 Step 1).

The compute hot spot of Antler's affinity analysis: one call per task and
branch point, O(K^2 F).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/pearson_gram.cu``, which replaces the Pallas TPU kernel
``repro/kernels/pearson_affinity.py::pearson_dissimilarity``.  On a CPU
tensor it runs the plain version, :func:`~repro_torch.kernels.ref.\
pearson_dissimilarity_ref`; there is no other fallback.

Bound on an H100: K*(K+1)*F fp32 FLOPs (the upper triangle) on the CUDA
cores (no TF32: the reference holds this function to 1e-5) against
K*F*4 + K*K*4 bytes — bound by operations at both of the main paths'
shapes.  The kernel splits F across blocks in two passes: one block per
(upper 64x64 tile pair, split of F) writes a partial tile to scratch, and a
second pass sums each pair's partials in split order and writes both
triangles.  No atomics, and :func:`split_plan` depends on (K, F) alone, so
the output is exactly symmetric and bit-identical from run to run and from
card to card.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pearson_dissimilarity_ref
from repro_torch.launch import op_cost, roofline

SOURCE = "pearson_gram.cu"
TILE = 64      # output rows/columns per tile
CHUNK = 256    # features per partial sum: a split is a whole number of chunks
# Pass 1's blocks the plan aims for: 8 per SM of a 132-SM H100, so that the
# last wave's imbalance is small.  A constant, never read from the card.
TARGET_BLOCKS = 8 * 132


@dataclass(frozen=True)
class SplitPlan:
    """How pass 1 cuts the work: ``pairs`` upper tile pairs times ``splits``
    feature ranges of ``span`` features each (the last one shorter)."""

    pairs: int
    splits: int
    span: int

    @property
    def blocks(self) -> int:
        return self.pairs * self.splits

    def ranges(self, f: int) -> List[Tuple[int, int]]:
        """The feature range ``[start, stop)`` of each split, in order."""
        return [(s * self.span, min((s + 1) * self.span, f)) for s in range(self.splits)]


def split_plan(k: int, f: int) -> SplitPlan:
    """The split of ``F`` for a (K, F) input: as many splits as bring pass 1
    to :data:`TARGET_BLOCKS` blocks, each a whole number of 256-feature
    chunks, no more splits than chunks.  A function of (K, F) alone."""
    tiles = -(-k // TILE)
    pairs = tiles * (tiles + 1) // 2
    chunks = max(1, -(-f // CHUNK))
    wanted = min(chunks, max(1, -(-TARGET_BLOCKS // max(pairs, 1))))
    per_split = -(-chunks // wanted)
    return SplitPlan(pairs=pairs, splits=-(-chunks // per_split), span=per_split * CHUNK)


@functools.lru_cache(maxsize=None)  # argtypes are set once
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.pearson_gram
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def pearson_dissimilarity(z: torch.Tensor) -> torch.Tensor:
    """``1 - Z Z^T`` for row-standardised ``z`` (K, F).  Returns (K, K) fp32.

    A CUDA ``z`` must be fp32, 2-D and contiguous; both passes launch on
    the current stream and :attr:`pearson_dissimilarity.launches` counts
    the call once.  The kernel has no backward: on CUDA, with grad enabled
    and ``z`` requiring grad, it raises ``NotImplementedError`` rather than
    return an output cut off from autograd.  On ``meta`` (a shape run) the
    same checks hold and the output has its shape only, nothing launched.
    Under an active :class:`~repro_torch.launch.op_cost.OpCounter` every
    route counts one launch of :func:`~repro_torch.launch.roofline.pearson_work`.
    """
    if z.device.type == "cpu":
        with op_cost.kernel("pearson_gram", lambda: roofline.pearson_work(*z.shape)):
            return pearson_dissimilarity_ref(z)
    if torch.is_grad_enabled() and z.requires_grad:
        raise NotImplementedError(
            "pearson_dissimilarity has no backward kernel: the affinity analysis needs no "
            "gradient, so call it under torch.no_grad() or on a detached tensor"
        )
    if z.dtype != torch.float32:
        raise TypeError(f"pearson_dissimilarity takes fp32, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"pearson_dissimilarity takes a 2-D (K, F) tensor, got {tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError("pearson_dissimilarity takes a contiguous tensor")
    if z.device.type not in ("cuda", "meta"):
        raise ValueError(f"pearson_dissimilarity runs on cuda, cpu or meta, not {z.device}")
    k, f = z.shape
    out = torch.empty((k, k), dtype=torch.float32, device=z.device)
    if k == 0:
        return out
    plan = split_plan(k, f)
    partial = torch.empty(plan.blocks * TILE * TILE, dtype=torch.float32, device=z.device)
    with op_cost.kernel("pearson_gram", lambda: roofline.pearson_work(k, f)):
        if z.device.type == "meta":
            return out
        lib = _library()
        with _build.on_device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            err = lib.pearson_gram(z.data_ptr(), partial.data_ptr(), out.data_ptr(), k, f,
                                   plan.splits, plan.span, stream)
    if err != 0:
        raise RuntimeError(f"pearson_gram launch failed: CUDA error {err}")
    pearson_dissimilarity.launches += 1
    return out


pearson_dissimilarity.launches = 0
