"""The Mamba2 chunked SSD scan (state-space duality, arXiv:2405.21060).

Every full-sequence SSD of the SSM and hybrid families (their ``forward``
and ``prefill``).  On CUDA tensors it launches the hand-written kernels in
``csrc/ssd_scan.cu``, which replace the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``.  On CPU tensors it runs the plain
version, :func:`~repro_torch.kernels.ref.ssd_scan_ref` (the port's
``models/ssm.py::ssd_chunked``); there is no other route.

Bound on an H100: ``B * nc * [2 Qc N + H (2 Qc P + 4 Q N P)]`` operations
(``Qc = Q (Q + 1) / 2``, causal pairs only) against x, dt, B and C read once
and y and the final state written once.  At the model shapes (bf16) the
bytes bound it under the bf16 tensor-core peak.

bf16 runs as three kernels on the tensor cores, in the order of
``ssd_chunked``'s phases: the chunks' own states and cumulative sums
(parallel over batch, chunk and head), the fp32 recurrence over chunks, then
y from C·Bᵀ (computed once per block for a group of heads), the stored
cumulative sums and the state entering each chunk.  They pass their results
through scratch that this wrapper allocates (:func:`scratch_shapes`); the
heads per block come from :func:`head_groups`.  fp32 runs the CUDA-core
kernel, one block per (batch, head) walking the chunks in order.  x, B and
C are read through their (batch, seq) strides, so the model's views of one
conv output go in without a copy; the bf16 kernels read them by TMA, which
needs a 16-byte aligned start and strides of whole 16 bytes, so a bf16 view
that lacks them is first copied to a padded layout (:func:`tma_ready`; the
model's views never are).

Under autograd (grad enabled and an input that requires it) the CUDA path
runs through :class:`SSDScanFunction`: the same forward launch, then the
backward kernels (:func:`ssd_scan_backward` in ``csrc/ssd_scan.cu``), which
replace XLA's autodiff of the reference's jnp oracle
``repro/models/ssm.py::ssd_chunked`` and compute what
:func:`~repro_torch.kernels.ref.ssd_scan_bwd_ref` computes.  bf16 runs seven
kernels, the chunk and the two pair kernels on the tensor cores (C·Bᵀ and
dy·xᵀ exact, the computed operands in bf16 hi + lo, dB and dC summed over a
block's heads in registers; x, B, C and dy read by TMA through
:func:`tma_ready`); fp32 runs eight CUDA-core kernels.  They recompute the
states entering each chunk from the saved inputs rather than keep the
forward's scratch, and pass their own fp32 scratch
(:func:`backward_scratch_shapes`).  Bound on an H100: x, dt, B, C and dy
read and dx, ddt, dB and dC written once; at the model shapes the bytes
bound it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.launch import op_cost, roofline

SOURCE = "ssd_scan.cu"
# (P, N) pairs with a template instance: the model shapes (mamba2-780m,
# zamba2-2.7b), the smoke configs', and the reference sweep's.
SHAPES = ((64, 128), (64, 64), (32, 16)) + tuple(
    (p, n) for p in (4, 8, 16) for n in (4, 8, 16)
)
CHUNKS = (8, 16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64  # rows of a bf16 tile: one wgmma M, one TMA box
# Blocks the bf16 chunk kernels aim for: four per SM of the H100's 132.
TARGET_BLOCKS = 4 * 132
MAX_GROUP = 8  # heads per block; the shared memory of the largest shapes allows 8


@functools.lru_cache(maxsize=None)  # argtypes are set once
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ssd_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    fn = lib.ssd_scan_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _group(units: int, heads: int) -> int:
    """The most heads per block (at most :data:`MAX_GROUP`) that still gives
    ``units`` x ceil(heads / group) >= :data:`TARGET_BLOCKS` blocks; 1 where
    none does."""
    g = MAX_GROUP
    while g > 1 and units * -(-heads // g) < TARGET_BLOCKS:
        g //= 2
    return g


def head_groups(batch: int, s: int, heads: int, chunk: int) -> Tuple[int, int]:
    """Heads per block of the bf16 chunk-state kernel (a block per batch row,
    chunk and head group) and of the chunk-scan kernel (a block per batch
    row, chunk, 64-row query tile and head group).  More heads per block
    share more loads (the chunk's B rows; its C·Bᵀ tiles), fewer give more
    blocks to fill the card.  A function of the shapes alone."""
    nc = -(-s // chunk)
    nt = -(-chunk // ROWS)
    return _group(batch * nc, heads), _group(batch * nc * nt, heads)


def scratch_shapes(
    batch: int, s: int, heads: int, p: int, n: int, chunk: int,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The bf16 path's scratch, each (shape, dtype): every chunk's own state
    S_c (fp32), the state entering every chunk as bf16 hi + lo (rows of N
    rounded up to 8 elements, TMA's 16 bytes), the chunks' cumulative sums of
    dt * a and their decays exp(cum_Q) (fp32).  The entering states have
    buffers of their own rather than overwriting S_c: the state pass then
    needs no block-wide read-before-write, at the cost of the memory."""
    nc = -(-s // chunk)
    nh = -(-n // 8) * 8
    return {
        "states": ((batch, nc, heads, p, n), torch.float32),
        "h_hi": ((batch, nc, heads, p, nh), torch.bfloat16),
        "h_lo": ((batch, nc, heads, p, nh), torch.bfloat16),
        "cum": ((batch, nc, heads, chunk), torch.float32),
        "decay": ((batch, nc, heads), torch.float32),
    }


def _nbytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def scratch_bytes(batch: int, s: int, heads: int, p: int, n: int, chunk: int) -> int:
    """Bytes of :func:`scratch_shapes`."""
    return sum(_nbytes(*v) for v in scratch_shapes(batch, s, heads, p, n, chunk).values())


def kernel_bytes(batch: int, s: int, heads: int, p: int, n: int, chunk: int) -> Dict[str, int]:
    """Bytes each bf16 kernel must move, each input read once and each output
    written once, scratch included: the chunk-state kernel reads x, dt, a
    and B and writes S_c, cum and decay; the state pass reads S_c and decay
    and writes the entering states and the final state; the chunk-scan
    kernel reads x, dt, B, C, cum and the entering states and writes y."""
    size = {k: _nbytes(*v) for k, v in scratch_shapes(batch, s, heads, p, n, chunk).items()}
    xy = 2 * batch * s * heads * p  # x read, or y written
    dt = 4 * batch * s * heads
    bc = 2 * batch * s * n  # B or C
    entering = size["h_hi"] + size["h_lo"]
    return {
        "ssd_chunk_state_kernel": xy + dt + 4 * heads + bc + size["states"] + size["cum"]
        + size["decay"],
        "ssd_state_pass_kernel": size["states"] + size["decay"] + entering
        + 4 * batch * heads * p * n,
        "ssd_chunk_scan_kernel": 2 * xy + dt + 2 * bc + size["cum"] + entering,
    }


def backward_groups(batch: int, s: int, heads: int, chunk: int) -> Tuple[int, int]:
    """Heads per block of the bf16 backward's chunk kernel (a block per
    batch row, chunk and head group) and of its two pair kernels (a block
    per batch row, chunk, 64-row tile and head group), today the forward's
    :func:`head_groups`.  The one source of the backward's grouping: both
    the launch (:func:`ssd_scan_backward`) and the scratch layout
    (:func:`backward_scratch_shapes`, whose dB and dC partials number
    ceil(heads / g3)) read it, so the two cannot disagree."""
    return head_groups(batch, s, heads, chunk)


def backward_scratch_shapes(
    batch: int, s: int, heads: int, p: int, n: int, chunk: int, dtype: torch.dtype,
) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The backward's fp32 scratch for inputs of ``dtype``, each (shape,
    dtype), in the order the kernels take it: the chunks' cumsums of dt * a
    and decays exp(cum_Q); every chunk's own state S_c, overwritten by the
    state entering the chunk (recomputed here: the forward saves none), and
    U_c, overwritten by the cotangent G_c of the state after the chunk;
    per-warp partials of <G_c, h_c>; the per-position terms of ddt and of
    the cumsum's cotangent; the partials of dB and dC before their
    fixed-order sum (bf16: one per head group of :func:`backward_groups`,
    summed in registers by the tensor-core kernels; fp32: one per head);
    each chunk's share of da; and, for fp32 only, C_I B_J^T of every pair
    of 64-row sub-tiles J <= I of a chunk, shared by its heads (the bf16
    kernels compute it per block)."""
    nc = -(-s // chunk)
    nt = -(-chunk // ROWS)
    f32 = torch.float32
    per_chunk = ((batch, nc, heads, chunk), f32)
    state = ((batch, nc, heads, p, n), f32)
    shapes = {
        "cum": per_chunk,
        "decay": ((batch, nc, heads), f32),
        "states": state,
        "cotangents": state,
        "state_dots": ((batch, nc, heads, -(-(p * n) // 128)), f32),
        "ddt_x": per_chunk,
        "dcum_k": per_chunk,
        "t": per_chunk,
        "dcum_q": per_chunk,
    }
    if dtype == torch.bfloat16:
        groups = -(-heads // backward_groups(batch, s, heads, chunk)[1])
        per_group = ((batch, s, groups, n), f32)
        shapes.update({"db_groups": per_group, "dc_groups": per_group,
                       "da_chunks": ((batch, nc, heads), f32)})
        return shapes
    per_head = ((batch, s, heads, n), f32)
    shapes.update({"db_heads": per_head, "dc_heads": per_head,
                   "da_chunks": ((batch, nc, heads), f32),
                   "cb_pairs": ((batch, nc, nt * (nt + 1) // 2, ROWS, ROWS), f32)})
    return shapes


def backward_scratch_bytes(batch: int, s: int, heads: int, p: int, n: int, chunk: int,
                           dtype: torch.dtype) -> int:
    """Bytes of :func:`backward_scratch_shapes`, before the 256-byte
    rounding of each buffer in the one allocation (:func:`_backward_layout`)."""
    return sum(_nbytes(*v)
               for v in backward_scratch_shapes(batch, s, heads, p, n, chunk, dtype).values())


@functools.lru_cache(maxsize=64)
def _backward_layout(
    buffers: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...],
) -> Tuple[Tuple[int, ...], int]:
    """Byte offsets of the (shape, dtype) ``buffers`` of
    :func:`backward_scratch_shapes` in one allocation (each 256-byte
    aligned), and its size: one ``torch.empty`` a call instead of one per
    buffer, which shows in a small call's host time."""
    offsets, total = [], 0
    for shape, dt in buffers:
        offsets.append(total)
        total += -(-_nbytes(shape, dt) // 256) * 256
    return tuple(offsets), total


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA can read it (a 16-byte aligned start, every
    stride but the last a multiple of 8 elements), else a copy into a buffer
    whose last dim is rounded up to 8 elements, returned as a view of the
    original shape (the padding is never read)."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    last = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], -(-last // 8) * 8), dtype=t.dtype, device=t.device)
    view = buf[..., :last]
    view.copy_(t)
    return view


def check_devices(*tensors: torch.Tensor) -> None:
    """All inputs on one device: the wrapper picks its route by device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan inputs must be on one device, got {sorted(map(str, devices))}")


def check_shape(p: int, n: int, chunk: int) -> None:
    """What the kernel takes: a (P, N) pair of :data:`SHAPES` and a chunk of
    :data:`CHUNKS`."""
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan takes (P, N) in {SHAPES}, got ({p}, {n})")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan takes a chunk in {CHUNKS}, got {chunk}")


def _check(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
) -> None:
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda, cpu or meta, not {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan takes x in fp32 or bf16, got {x.dtype}")
    if b_in.dtype != x.dtype or c_in.dtype != x.dtype:
        raise TypeError(f"x, B and C differ in dtype: {x.dtype}, {b_in.dtype}, {c_in.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes dt and a in fp32, got {dt.dtype}, {a.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b_in.shape) != (bsz, s, n) or c_in.shape != b_in.shape):
        raise ValueError(
            f"shapes do not agree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
            f"B {tuple(b_in.shape)}, C {tuple(c_in.shape)}"
        )
    check_shape(p, n, chunk)
    if any(t.stride(-1) != 1 for t in (x, b_in, c_in)) or a.stride(0) != 1:
        raise ValueError("ssd_scan needs the last dim of x, B, C and a contiguous")


def _forward(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on the current stream: y and the final state
    (on ``meta`` their shapes only, nothing launched)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz * h == 0:
        return y, fin
    scratch, g1, g3 = [], 0, 0
    if x.dtype == torch.bfloat16:
        x, b_in, c_in = (tma_ready(t) for t in (x, b_in, c_in))
        scratch = [torch.empty(shape, dtype=dtype, device=x.device)
                   for shape, dtype in scratch_shapes(bsz, s, h, p, n, chunk).values()]
        g1, g3 = head_groups(bsz, s, h, chunk)
    with op_cost.kernel("ssd_scan", lambda: roofline.ssd_work(bsz, s, h, p, n, chunk, x.dtype)):
        if x.device.type == "meta":
            return y, fin
        lib = _library()
        with _build.on_device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
                y.data_ptr(), fin.data_ptr(), _DTYPE_CODES[x.dtype], bsz, s, h, p, n, chunk,
                x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
                b_in.stride(0), b_in.stride(1), c_in.stride(0), c_in.stride(1),
                *([t.data_ptr() for t in scratch] or [0] * 5), g1, g3, stream,
            )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, fin


def ssd_scan_backward(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor,
    dy: torch.Tensor, d_final: Optional[torch.Tensor], chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on the current stream: ``(dx, ddt, da, dB,
    dC)`` for the cotangents ``dy`` of y (x's dtype) and ``d_final`` of the
    final state (fp32, or None for zero), as
    :func:`~repro_torch.kernels.ref.ssd_scan_bwd_ref` computes them.  The
    inputs are the forward's, read through their strides; the outputs are
    contiguous.  :attr:`ssd_scan.backward_launches` counts the call once,
    and :attr:`ssd_scan.backward_scratch_allocated` holds the bytes of the
    scratch it allocated.  CUDA only, or ``meta``: the gradients' shapes
    and dtypes, nothing launched."""
    _check(x, dt, a, b_in, c_in, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} {dy.dtype} vs "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if d_final is not None:
        if tuple(d_final.shape) != (bsz, h, p, n):
            raise ValueError(f"d_final must be (B, H, P, N), got {tuple(d_final.shape)}")
        d_final = d_final.to(torch.float32).contiguous()
    dy = dy if dy.stride(-1) == 1 else dy.contiguous()
    g1 = g3 = 0
    if x.dtype == torch.bfloat16:
        x, b_in, c_in, dy = (tma_ready(t) for t in (x, b_in, c_in, dy))
        g1, g3 = backward_groups(bsz, s, h, chunk)
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=x.device)
    da = torch.zeros((h,), dtype=torch.float32, device=x.device)
    db = torch.empty((bsz, s, n), dtype=b_in.dtype, device=x.device)
    dc = torch.empty((bsz, s, n), dtype=c_in.dtype, device=x.device)
    if bsz * h == 0 or s == 0:
        ssd_scan.backward_scratch_allocated = 0
        return dx, ddt, da, db.zero_(), dc.zero_()
    with op_cost.kernel("ssd_scan_bwd", lambda: roofline.ssd_bwd_work(
            bsz, s, h, p, n, chunk, x.dtype, d_final is not None)):
        if x.device.type == "meta":
            return dx, ddt, da, db, dc
        err = _launch_bwd(x, dt, a, b_in, c_in, dy, d_final, dx, ddt, da, db, dc, chunk, g1, g3)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error {err}")
    ssd_scan.backward_launches += 1
    return dx, ddt, da, db, dc


def _launch_bwd(x, dt, a, b_in, c_in, dy, d_final, dx, ddt, da, db, dc, chunk: int,
                g1: int, g3: int) -> int:
    """The backward kernels' one C call, its scratch allocated here: the
    C entry point's error code."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    offsets, total = _backward_layout(
        tuple(backward_scratch_shapes(bsz, s, h, p, n, chunk, x.dtype).values()))
    scratch = torch.empty((total,), dtype=torch.uint8, device=x.device)
    ssd_scan.backward_scratch_allocated = scratch.numel()
    strides = (ctypes.c_longlong * 13)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        b_in.stride(0), b_in.stride(1), c_in.stride(0), c_in.stride(1),
        dy.stride(0), dy.stride(1), dy.stride(2))
    base = scratch.data_ptr()
    pointers = (ctypes.c_void_p * len(offsets))(*(base + off for off in offsets))
    lib = _library()
    with _build.on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
            dy.data_ptr(), None if d_final is None else d_final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
            _DTYPE_CODES[x.dtype], bsz, s, h, p, n, chunk, g1, g3, strides, pointers, stream,
        )
    return err


class SSDScanFunction(torch.autograd.Function):
    """The kernels under autograd: the forward launches the inference
    kernels (the same bits as without grad) and saves its inputs; the
    backward launches the backward kernels, which recompute the entering
    states from them.  An unused final state gives no cotangent (None)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        ctx.chunk = chunk
        return _forward(x, dt, a, b_in, c_in, chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b_in, c_in = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        dx, ddt, da, db, dc = ssd_scan_backward(x, dt, a, b_in, c_in, dy, d_final, ctx.chunk)
        return dx, ddt, da, db, dc, None


class PlainSSDFunction(torch.autograd.Function):
    """The SSD's plain versions under autograd: :func:`ssd_scan_ref`
    forward, :func:`~repro_torch.kernels.ref.ssd_scan_bwd_ref` backward,
    each counted as the kernels' launch by an active
    :class:`~repro_torch.launch.op_cost.OpCounter` (autograd through
    ``ssd_chunked`` itself gives NaN for dt and a where a masked exp
    overflows, ``tests/test_torch_ssd_backward.py``)."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b_in, c_in)
        ctx.chunk = chunk
        with op_cost.kernel("ssd_scan", lambda: roofline.ssd_work(
                *x.shape, b_in.shape[-1], chunk, x.dtype)):
            return ssd_scan_ref(x, dt, a, b_in, c_in, chunk)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a, b_in, c_in = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        with op_cost.kernel("ssd_scan_bwd", lambda: roofline.ssd_bwd_work(
                *x.shape, b_in.shape[-1], ctx.chunk, x.dtype, d_final is not None)):
            return (*ssd_scan_bwd_ref(x, dt, a, b_in, c_in, dy, d_final, ctx.chunk), None)


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
    b_in: torch.Tensor, c_in: torch.Tensor, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CPU route: the plain version, differentiable by autograd.  Under
    an active :class:`~repro_torch.launch.op_cost.OpCounter` the call
    counts as one kernel launch and the plain version's own ops not on top;
    with grad it then runs through :class:`PlainSSDFunction`, so that its
    backward counts as the backward kernels' launch."""
    if op_cost.active_counter() is None:
        return ssd_scan_ref(x, dt, a, b_in, c_in, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b_in, c_in)):
        return PlainSSDFunction.apply(x, dt, a, b_in, c_in, chunk)
    with op_cost.kernel("ssd_scan", lambda: roofline.ssd_work(
            *x.shape, b_in.shape[-1], chunk, x.dtype)):
        return ssd_scan_ref(x, dt, a, b_in, c_in, chunk)


def ssd_scan(
    x: torch.Tensor,      # (B, S, H, P) activation dtype
    dt: torch.Tensor,     # (B, S, H) fp32, positive step sizes
    a: torch.Tensor,      # (H,) fp32, negative decay rates
    b_in: torch.Tensor,   # (B, S, N) activation dtype
    c_in: torch.Tensor,   # (B, S, N) activation dtype
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: ``(y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    fp32)``, starting from a zero state.

    On CUDA the kernel launches on the current stream and
    :attr:`ssd_scan.launches` counts it; with grad enabled and an input
    that requires grad it runs through :class:`SSDScanFunction`, whose
    backward launches the backward kernels (:attr:`ssd_scan.backward_launches`).
    On the CPU the plain version runs, differentiable by autograd
    (:func:`ssd_scan_plain`).  On ``meta`` (a shape run) the same checks
    hold and the outputs and gradients come back with their shapes and
    dtypes, nothing launched.
    """
    check_devices(x, dt, a, b_in, c_in)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b_in, c_in, chunk)
    _check(x, dt, a, b_in, c_in, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b_in, c_in)):
        return SSDScanFunction.apply(x, dt, a, b_in, c_in, chunk)
    return _forward(x, dt, a, b_in, c_in, chunk)


ssd_scan.launches = 0
ssd_scan.backward_launches = 0
ssd_scan.backward_scratch_allocated = 0  # bytes, the last backward call's scratch
