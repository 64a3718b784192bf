"""Flash attention: online-softmax attention, causal and/or sliding-window.

The attention of every layer of the dense transformer family and the
hybrid family's shared attention block, on full sequences (the multitask
program's blocks, the models' ``forward`` and the LM server's prefill).  On
CUDA tensors it launches the hand-written kernel in
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and the ``jnp.repeat``
of its GQA wrapper.  On CPU tensors it runs the plain version,
:func:`~repro_torch.kernels.ref.flash_attention_ref`; there is no other
route.

Bound on an H100: 4 * (allowed query-key pairs) * d operations per head
against q, k, v and o moved once — at the main paths' shapes (S = 128 or 512,
d = 160, bf16, GQA 32/8; S = 1024, d = 80, 32/32 heads for zamba2-2.7b) the
bytes bound it under the bf16 tensor-core peak.
bf16 runs on the tensor cores: ``wgmma`` for Q K^T and for P V (P rounded
to bf16 in registers), a persistent grid whose blocks walk work items while
TMA keeps the next K/V tile (and the next item's Q) in flight, the running
max and sum and the output accumulator in fp32 registers.  fp32 runs on the
CUDA cores, since TF32 cannot meet its 2e-5.  Both map query head h to KV
head h / (Hq / Hk) instead of repeating K/V, read the model layout
(B, S, H, d) and the flattened (B*H, S, d) layout through strides without a
copy, and skip KV tiles that the mask removes entirely.  TMA needs a
16-byte aligned start and strides of whole 16 bytes, so a bf16 view that
has neither is copied to a fresh tensor first (no entry point makes one).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)  # argtypes are set once
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    """What the kernel takes: fp32 or bf16 on one CUDA device, equal dtypes,
    a head_dim of :data:`HEAD_DIMS`, contiguous head dims."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ in shape")
    d = q.shape[-1]
    if d not in HEAD_DIMS or k.shape[-1] != d:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the bf16 kernel's TMA can read it (a 16-byte aligned
    start, every stride but the last a multiple of 8 elements), else a
    contiguous copy.  fp32 tensors pass unchanged."""
    if x.dtype != torch.bfloat16:
        return x
    if x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:-1]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_rows(s: int, t: int, window: Optional[int]) -> None:
    """Every query row must keep at least one key.  Row ``i`` keeps none when
    ``t == 0`` or, under a window, when ``i >= t + window - 1`` (reachable
    only without the causal mask and with ``s > t``).  The plain version
    then averages V over the masked keys while the kernel, which skips the
    masked tiles, would write 0; no entry point reaches such a row, so the
    kernel refuses it."""
    if t == 0 or (window is not None and s >= t + window):
        raise ValueError(
            f"query rows without any allowed key (S={s}, T={t}, window={window})"
        )


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    batch: int, hq: int, hk: int, s: int, t: int,
    strides, causal: bool, window: Optional[int],
) -> None:
    """One kernel launch; ``strides`` are (batch, seq, head) element strides
    of q, k, v and o in that order."""
    if batch * hq == 0 or s == 0:
        return
    _check_rows(s, t, window)
    lib = _library()
    d = q.shape[-1]
    flat = [int(x) for st in strides for x in st]
    with _build.on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, hq, hk, s, t, d, *flat,
            int(causal), 0 if window is None else int(window),
            1.0 / math.sqrt(d), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Attention over flattened (batch*heads) slices.

    ``q`` is (BH, S, d); ``k`` and ``v`` are (BHk, T, d) with BH a multiple
    of BHk (query slice ``i`` reads KV slice ``i // (BH / BHk)``).  Returns
    (BH, S, d) in ``q``'s dtype.  On CUDA the kernel launches on the current
    stream and :attr:`flash_attention.launches` counts it.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_attention takes (BH, S, d) tensors, got {tuple(q.shape)}")
    bh, s, _d = q.shape
    bhk, t, _ = k.shape
    if bhk == 0 or bh % bhk != 0:
        raise ValueError(f"BH {bh} is not a multiple of BHk {bhk}")
    q, k, v = (_aligned(x) for x in (q, k, v))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # Batch = the KV slices, heads = the query slices sharing one of them.
    rep = bh // bhk
    strides = [
        (rep * q.stride(0), q.stride(1), q.stride(0)),
        (k.stride(0), k.stride(1), 0),
        (v.stride(0), v.stride(1), 0),
        (rep * o.stride(0), o.stride(1), o.stride(0)),
    ]
    _launch(q, k, v, o, bhk, rep, 1, s, t, strides, causal, window)
    return o


def flash_attention_bhsd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel on the model layout: ``q`` (B, S, Hq, d), ``k``/``v``
    (B, T, Hk, d), read in place through their strides.  CUDA only; callers
    go through :func:`repro_torch.kernels.ops.flash_attention_bhsd`."""
    _check(q, k, v, window)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected (B, S, H, d) tensors, got {tuple(q.shape)}")
    b, s, hq, _d = q.shape
    bk, t, hk, _ = k.shape
    if bk != b or hk == 0 or hq % hk != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not group")
    q, k, v = (_aligned(x) for x in (q, k, v))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [(x.stride(0), x.stride(1), x.stride(2)) for x in (q, k, v, o)]
    _launch(q, k, v, o, b, hq, hk, s, t, strides, causal, window)
    return o


flash_attention.launches = 0
