"""The Mamba2 chunked SSD scan (state-space duality, arXiv:2405.21060).

Every full-sequence SSD of the SSM and hybrid families (their ``forward``
and ``prefill``).  On CUDA tensors it launches the hand-written kernel in
``csrc/ssd_scan.cu``, which replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``.  On CPU tensors it runs the plain
version, :func:`~repro_torch.kernels.ref.ssd_scan_ref` (the port's
``models/ssm.py::ssd_chunked``); there is no other route.

Bound on an H100: ``B * nc * [2 Qc N + H (2 Qc P + 4 Q N P)]`` operations
(``Qc = Q (Q + 1) / 2``, causal pairs only) against x, dt, B and C read once
and y and the final state written once.  At the model shapes (bf16) the
bytes bound it under the bf16 tensor-core peak.  The kernel gives one block
to each (batch, head), walks the chunks in order with the (P, N) fp32 state
in shared memory, and computes the intra-chunk term as causal 64 x 64 tiles
on the CUDA cores in fp32.  x, B and C are read through their (batch, seq)
strides, so the model's views of one conv output go in without a copy.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

SOURCE = "ssd_scan.cu"
# (P, N) pairs with a template instance: the model shapes (mamba2-780m,
# zamba2-2.7b), the smoke configs', and the reference sweep's.
SHAPES = ((64, 128), (64, 64), (32, 16)) + tuple(
    (p, n) for p in (4, 8, 16) for n in (4, 8, 16)
)
CHUNKS = (8, 16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ssd_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


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
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
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
    :attr:`ssd_scan.launches` counts it; on the CPU the plain version runs.
    """
    check_devices(x, dt, a, b_in, c_in)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b_in, c_in, chunk)
    _check(x, dt, a, b_in, c_in, chunk)
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz * h == 0:
        return y, fin
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
            y.data_ptr(), fin.data_ptr(), _DTYPE_CODES[x.dtype], bsz, s, h, p, n, chunk,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
            b_in.stride(0), b_in.stride(1), c_in.stride(0), c_in.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, fin


ssd_scan.launches = 0
