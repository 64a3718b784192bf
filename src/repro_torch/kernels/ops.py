"""Public wrappers around the port's kernels."""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_bhsd_kernel, flash_attention_plain
from repro_torch.kernels.pearson_affinity import pearson_dissimilarity
from repro_torch.kernels.ref import flash_attention_bhsd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan
from repro_torch.launch import op_cost


def standardize_rows(feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """fp32 rows centred and scaled to unit L2 norm (Pearson normalisation),
    as ``repro/kernels/ops.py`` does before its kernel."""
    z = feats.float()
    z = z - z.mean(dim=-1, keepdim=True)
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True), min=eps)


def pairwise_pearson_dissimilarity(feats: torch.Tensor) -> torch.Tensor:
    """Standardise the rows of ``feats`` (K, F) in fp32, then ``1 - Gram``.

    Any input dtype (bf16 included) is cast to fp32 first; the result is
    (K, K) fp32.  A CUDA input launches the Pearson kernel.
    """
    return pearson_dissimilarity(standardize_rows(feats).contiguous())


def flash_attention_bhsd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """GQA flash attention in model layout (``repro/kernels/ops.py``).

    ``q`` (B, S, Hq, d), ``k``/``v`` (B, T, Hk, d) with Hq a multiple of
    Hk; returns (B, S, Hq, d) in ``q``'s dtype.  A CUDA input launches the
    flash-attention kernel, which reads the KV head of each query head in
    place; a CPU input runs the plain version (counted as the kernel's
    launches under an active ``OpCounter``); a ``meta`` input returns
    the output's shape and dtype, launching nothing.  ``DTensor`` inputs (a
    mesh engine's activations) run per rank on the local batch rows and
    heads (:func:`_flash_on_mesh`).
    """
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        return _flash_on_mesh(q, k, v, causal, window)
    if q.device.type == "cpu":
        if op_cost.active_counter() is None:
            return flash_attention_bhsd_ref(q, k, v, causal=causal, window=window)
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return flash_attention_bhsd_kernel(q, k, v, causal=causal, window=window)


class MeshHeads(NamedTuple):
    """How attention of a ``DTensor`` query (B, S, Hq, d) over Hk KV heads
    runs per rank (:func:`mesh_heads`): one placement per mesh dimension
    for q and the output, for K and V, and for K's and V's gradients;
    and ``narrow``, the (offset, count) of the KV heads this rank reads
    within its local K and V where it reads only some of them (else
    ``None``)."""

    q: List[Any]
    kv: List[Any]
    kv_grad: List[Any]
    narrow: Optional[Tuple[int, int]]


def mesh_heads(q: Any, hk: int) -> MeshHeads:
    """The per-rank layout of attention of ``DTensor`` ``q`` over ``hk`` KV
    heads, the reference's: every mesh dimension over which ``q`` shards its
    batch keeps it sharded (K and V alike), and every other dimension that
    divides Hq splits the query heads.  The KV heads split with them where
    Hk divides too; otherwise each rank holds K and V whole on that
    dimension and reads only the KV head(s) its own query heads read (its
    gradients come back as partial sums over the ranks sharing a KV head).
    A split that would hand one rank query heads of two KV groups without
    the whole of either raises ``ValueError``.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.sharding.utils import local_extent

    mesh = q.device_mesh
    hq = q.shape[2]
    qpl, kvpl, grad = [], [], []
    qsplit = ksplit = 1
    for mdim, pl in enumerate(q.placements):
        n = mesh.size(mdim)
        if pl == Shard(0):
            qpl.append(Shard(0))
            kvpl.append(Shard(0))
            grad.append(Shard(0))
        elif n > 1 and hq % (qsplit * n) == 0:
            qpl.append(Shard(2))
            if ksplit == qsplit and hk % (ksplit * n) == 0:
                ksplit *= n
                kvpl.append(Shard(2))
                grad.append(Shard(2))
            else:
                kvpl.append(Replicate())
                grad.append(Partial())
            qsplit *= n
        else:
            qpl.append(Replicate())
            kvpl.append(Replicate())
            grad.append(Replicate())
    if qsplit == ksplit:
        return MeshHeads(qpl, kvpl, grad, None)
    per, group = hq // qsplit, hq // hk
    if group % per:
        raise ValueError(
            f"{hq} query heads over {hk} KV heads split {qsplit} ways: a rank's "
            f"{per} query heads straddle two KV heads")
    q0 = local_extent(q.shape, qpl, mesh)[2][0]
    k0 = local_extent((*q.shape[:2], hk, q.shape[3]), kvpl, mesh)[2][0]
    return MeshHeads(qpl, kvpl, grad, (q0 // group - k0, 1))


def _flash_on_mesh(q, k, v, causal: bool, window: Optional[int]):
    """Flash attention of ``DTensor`` q, k, v through ``local_map``, laid out
    by :func:`mesh_heads`: each rank attends its own batch rows and query
    heads over the KV heads they read — the kernel on CUDA (one launch per
    rank, counted once in ``flash_attention.launches``), the plain version
    on the CPU."""
    from torch.distributed.tensor.experimental import local_map

    heads = mesh_heads(q, k.shape[2])

    def attend(a, b, c):
        if heads.narrow is not None:
            b, c = (t.narrow(2, *heads.narrow).contiguous() for t in (b, c))
        return flash_attention_bhsd(a, b, c, causal=causal, window=window)

    return local_map(
        attend, out_placements=heads.q, in_placements=(heads.q, heads.kv, heads.kv),
        in_grad_placements=(heads.q, heads.kv_grad, heads.kv_grad),
        device_mesh=q.device_mesh, redistribute_inputs=True,
    )(q, k, v)


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 chunked SSD (``repro/kernels/ops.py::ssd_scan``): ``x``
    (B, S, H, P), ``dt`` (B, S, H) fp32, ``a`` (H,) fp32, ``b_in``/``c_in``
    (B, S, N); returns (y (B, S, H, P) in ``x``'s dtype, final state
    (B, H, P, N) fp32).  A CUDA input launches the SSD kernel, which reads
    x, B and C through their strides; a CPU input runs the plain version.
    ``DTensor`` inputs (a mesh model's activations) run per rank on the
    local batch rows and heads (:func:`_ssd_on_mesh`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _ssd_on_mesh(x, dt, a, b_in, c_in, chunk)
    return _ssd_scan(x, dt, a, b_in, c_in, chunk)


def _ssd_on_mesh(x, dt, a, b_in, c_in, chunk: int):
    """The SSD of ``DTensor`` inputs through ``local_map``.

    Every mesh dimension over which ``x`` shards its batch keeps it sharded
    (x, dt, B, C and the final state split together); each other dimension
    splits the heads of x, dt, ``a`` and the final state where they divide
    and replicates them otherwise, with B and C (shared by every head)
    replicated.  Each rank scans its local rows and heads: the kernel on
    CUDA (one launch per rank, counted once in ``ssd_scan.launches``; under
    autograd ``SSDScanFunction`` and its backward kernels), the plain
    version on the CPU.  The gradients of what a rank holds whole but only
    part of the work reads are partial sums: ``a``'s over the batch
    shards, B's and C's over the head shards.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    # Per mesh dimension, the placements of (x and dt, the final state, a,
    # B and C) and the gradients' of (a, B and C): batch-split, head-split
    # or replicated.
    batch = (Shard(0), Shard(0), Replicate(), Shard(0), Partial(), Shard(0))
    heads = (Shard(2), Shard(1), Shard(0), Replicate(), Shard(0), Partial())
    whole = (Replicate(),) * 6
    rows, split = [], 1
    for mdim, pl in enumerate(x.placements):
        n = mesh.size(mdim)
        if pl == Shard(0):
            rows.append(batch)
        elif n > 1 and x.shape[2] % (split * n) == 0:
            split *= n
            rows.append(heads)
        else:
            rows.append(whole)
    xl, sl, al, bl, ga, gb = (list(c) for c in zip(*rows))
    return local_map(
        lambda *t: _ssd_scan(*t, chunk),
        out_placements=(xl, sl),
        in_placements=(xl, xl, al, bl, bl),
        in_grad_placements=(xl, xl, ga, gb, gb),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, dt, a, b_in, c_in)
