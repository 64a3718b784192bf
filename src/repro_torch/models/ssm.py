"""Mamba2 (state-space duality) blocks — the `ssm` family (arXiv:2405.21060),
the PyTorch port of ``repro.models.ssm``.

The SSD layer computes, per head h with scalar decay ``A_h < 0``:

    s_t = exp(dt_t A) s_{t-1} + dt_t x_t ⊗ B_t          (state: P x N)
    y_t = C_t · s_t + D x_t

A full sequence (``forward``, ``prefill``) goes through
:func:`repro_torch.kernels.ops.ssd_scan`: the hand-written SSD kernel on
CUDA, its plain version — :func:`ssd_chunked` here — on the CPU, where the
reference calls its jnp oracle ``ssd_chunked``.  Decode is the one-step
recurrence :func:`ssd_decode_step` against an
:class:`~repro_torch.models.cache.SSMCache`.

Layer parameters stay stacked with a leading L axis, as in the reference,
so its trees carry over unchanged; the port loops over the layers where the
reference scans.  The entry points take the reference's sharding ``policy``
last (``TP_POLICY`` by default).  On a mesh the Mamba2 heads shard over
``model`` at ``xh`` (the reference's ``shard_act``), the SSD runs on each
rank's local rows and heads (``ops.ssd_scan``'s ``local_map``), and a
decode step writes each layer's conv window and state on the local shards
of the cache, which keeps ``ssm_cache_spec``'s layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.cache import SSMCache, prefill_cache, ssm_cache_shape, ssm_cache_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    draw_stacked, layer_params, num_stacked, stacked_specs, token_ids,
)
from repro_torch.sharding.policy import TP_POLICY, P, ShardingPolicy, shard_act
from repro_torch.sharding.utils import (
    column_einsum, gather_fsdp, gathered_einsum, is_dtensor, mesh_of, on_mesh, row_einsum,
    write_rows,
)

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# SSD core (chunked) + sequential reference
# --------------------------------------------------------------------------

def ssd_chunked(
    x: torch.Tensor,      # (B, S, H, P)
    dt: torch.Tensor,     # (B, S, H)  positive step sizes
    a: torch.Tensor,      # (H,)       negative decay rates
    b_in: torch.Tensor,   # (B, S, N)
    c_in: torch.Tensor,   # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch: returns (y (B,S,H,P), final_state (B,H,P,N)).

    The reference's 4-operand einsums are taken as explicit pairwise steps,
    so the contraction order and the peak memory do not depend on an
    einsum optimiser: the largest intermediate is the (B, nc, Q, Q, H)
    masked decay.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc, q = (s + pad) // chunk, chunk

    xf = x.reshape(bsz, nc, q, h, p).float()
    dtf = dt.reshape(bsz, nc, q, h).float()
    bf = b_in.reshape(bsz, nc, q, n).float()
    cf = c_in.reshape(bsz, nc, q, n).float()

    da_cum = torch.cumsum(dtf * a.float(), dim=2)  # (B,nc,q,H), negative

    # Intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
    cb = torch.einsum("bcqn,bckn->bcqk", cf, bf)                      # (B,nc,q,q)
    decay = torch.exp(da_cum[:, :, :, None, :] - da_cum[:, :, None, :, :])
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # A select, not a 0/1 product: exp overflows above the diagonal.
    lmat = torch.where(causal[None, None, :, :, None], decay, torch.zeros((), device=x.device))
    dx = dtf[..., None] * xf                                          # (B,nc,k,H,P)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", lmat * cb[..., None], dx)

    # Chunk-final states: S_c = sum_j B_j ⊗ dt_j x_j exp(cum_Q - cum_j)
    to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)                # (B,nc,q,H)
    s_chunk = torch.einsum("bckhp,bckn->bchpn", to_end[..., None] * dx, bf)

    # Inter-chunk recurrence over nc chunks.
    chunk_decay = torch.exp(da_cum[:, :, -1, :])                      # (B,nc,H)
    state = (
        init_state.float() if init_state is not None
        else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    )
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(prevs, dim=1)                               # (B,nc,H,P,N)

    # Inter-chunk contribution: y_i += C_i · (h_prev) * exp(cum_i)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cf, h_prevs) * torch.exp(da_cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_sequential_ref(x, dt, a, b_in, c_in, init_state=None):
    """Naive per-step recurrence (oracle for tests)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    st = (
        init_state.float() if init_state is not None
        else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    )
    ys = []
    for t in range(s):
        y_t, st = ssd_decode_step(st, x[:, t], dt[:, t], a, b_in[:, t], c_in[:, t])
        ys.append(y_t.float())
    return torch.stack(ys, dim=1).to(x.dtype), st


def ssd_decode_step(state, x, dt, a, b_in, c_in):
    """One-token recurrence.  state (B,H,P,N); x (B,H,P); dt (B,H); b/c (B,N)."""
    dtf = dt.float()
    dec = torch.exp(dtf * a.float())
    upd = (dtf[:, :, None] * x.float())[..., None] * b_in.float()[:, None, None, :]
    state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_in.float())
    return y.to(x.dtype), state


# --------------------------------------------------------------------------
# Causal depthwise conv (width ssm_conv_width) on (x, B, C)
# --------------------------------------------------------------------------

def causal_conv(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """u: (B, S, C); kernel: (W, C).  y[t] = sum_w k[w] u[t - W + 1 + w]."""
    w = kernel.shape[0]
    pad = F.pad(u, (0, 0, w - 1, 0))
    s = u.shape[1]
    # In u's own layout (on a mesh its own rows), as the reference's zeros_like.
    out = torch.zeros_like(u, dtype=torch.float32)
    for i in range(w):
        out = out + kernel[i].float() * pad[:, i : i + s].float()
    return out.to(u.dtype)


def silu_conv(u: Any, kernel: Any) -> Any:
    """SiLU of :func:`causal_conv` (in fp32), in ``u``'s dtype.  The conv is
    depthwise, so a ``DTensor`` ``u`` is convolved per rank on its own rows
    and channels (:func:`_conv_on_mesh`)."""
    if is_dtensor(u):
        return _conv_on_mesh(u, kernel)
    return F.silu(causal_conv(u, kernel).float()).to(u.dtype)


def _conv_on_mesh(u: Any, kernel: Any) -> Any:
    """:func:`silu_conv` of a ``DTensor`` ``u`` through ``local_map``: each
    rank convolves its own batch rows and channels (the sequence whole) with
    its own columns of ``kernel`` (held whole), and nothing moves.  The
    output's gradient is brought to ``u``'s layout once (a partial sum is
    reduced there, not first split by the SiLU's backward and then
    gathered), and the kernel's lands in its own columns, a partial sum
    over the rows' shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    upl = [Replicate() if pl.is_shard(1) else pl for pl in u.placements]
    # Per mesh dim, the placements of (the kernel, its gradient).
    rows = [(Shard(1), Shard(1)) if pl.is_shard(2) else
            (Replicate(), Partial()) if pl.is_shard() else (Replicate(), Replicate())
            for pl in upl]
    kpl, kgrad = (list(c) for c in zip(*rows))
    return local_map(
        silu_conv, out_placements=upl, in_placements=(upl, kpl), in_grad_placements=(upl, kgrad),
        device_mesh=u.device_mesh, redistribute_inputs=True,
    )(u, kernel)


def causal_conv_step(
    cache: torch.Tensor, u_t: torch.Tensor, kernel: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache: (B, W-1, C) last inputs; u_t: (B, C).  Returns (y_t, new cache)."""
    window = torch.cat([cache, u_t[:, None, :]], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window.float(), kernel.float())
    return y.to(u_t.dtype), window[:, 1:]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def _in_proj(params: Params, u: torch.Tensor):
    """Input projections, wz/wx fused on a stack axis (D, 2, di); on a mesh
    B and C, which every head reads, are computed a column slice per rank
    and gathered (:func:`~repro_torch.sharding.utils.gathered_einsum`)."""
    zx = column_einsum("bsd,dkm->bskm", u, params["w_zx"], 2, 3)
    z, xin = zx[:, :, 0], zx[:, :, 1]
    b_in, c_in = (gathered_einsum("bsd,dn->bsn", u, params[k], 1, 2) for k in ("wb", "wc"))
    return z, xin, b_in, c_in, u @ params["wdt"]


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float,
             device: torch.device) -> torch.Tensor:
    """``n`` fp32 uniforms drawn on the generator's device; on ``meta`` the
    shape alone, nothing drawn."""
    if device.type == "meta":
        return torch.empty((n,), device=device)
    return torch.empty((n,), device=generator.device).uniform_(lo, hi, generator=generator)


def init_mamba_block(
    generator: torch.Generator, cfg: ModelConfig, device: torch.device
) -> Params:
    dtype = cfg.params_dtype()
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    wz = L.dense_init(generator, d, (di,), dtype, device)
    wx = L.dense_init(generator, d, (di,), dtype, device)
    wb = L.dense_init(generator, d, (n,), dtype, device)
    wc = L.dense_init(generator, d, (n,), dtype, device)
    wdt = L.dense_init(generator, d, (h,), dtype, device)
    dt0 = torch.exp(_uniform(generator, h, math.log(1e-3), math.log(1e-1), device))
    a_log = torch.log(_uniform(generator, h, 1.0, 16.0, device))
    conv_dim = di + 2 * n
    if device.type == "meta":
        conv = torch.empty((cfg.ssm_conv_width, conv_dim), device=device)
    else:
        conv = torch.empty((cfg.ssm_conv_width, conv_dim), device=generator.device)
        conv.normal_(0.0, 1.0, generator=generator)
    return {
        "norm": L.init_rmsnorm(d, dtype, device),
        "w_zx": torch.stack([wz, wx], dim=1),  # (D, 2, di): z and x fused
        "wb": wb,
        "wc": wc,
        "wdt": wdt,
        "dt_bias": torch.log(torch.expm1(dt0)).to(device=device),  # softplus^-1(dt0)
        "a_log": a_log.to(device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "conv": (conv * 0.2).to(device=device, dtype=dtype),
        "gated_norm": L.init_rmsnorm(di, dtype, device),
        "wo": L.dense_init(generator, di, (d,), dtype, device),
    }


def spec_mamba_block(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    m, f = policy.physical("model"), policy.physical("fsdp")
    return {
        "norm": L.spec_rmsnorm(),
        "w_zx": P(f, None, m),
        "wb": P(f, None),
        "wc": P(f, None),
        "wdt": P(f, m),
        "dt_bias": P(None),
        "a_log": P(None),
        "d_skip": P(None),
        "conv": P(None, None),
        "gated_norm": L.spec_rmsnorm(),
        "wo": P(m, f),
    }


def _ssd_inputs(lp: Params, xin: torch.Tensor, dt_raw: torch.Tensor, cfg: ModelConfig):
    """x (B, S, H, P) of the conv's x channels, dt (fp32, softplus) and
    a = -exp(a_log)."""
    bsz, s, _ = xin.shape
    dt = F.softplus(dt_raw.float() + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    return xin.reshape(bsz, s, cfg.ssm_n_heads, cfg.ssm_head_dim), dt, a


def _gate_out(lp: Params, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """D skip, SiLU(z) gate, gated norm and the output projection.  On a
    mesh ``d_inner`` stays split throughout (the norm's sum of squares is
    all-reduced: :func:`~repro_torch.models.layers.rmsnorm`)."""
    bsz, s = y.shape[:2]
    y = y + lp["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(bsz, s, cfg.ssm_d_inner)
    gated = y * F.silu(z.float()).to(y.dtype)
    gated = L.rmsnorm(lp["gated_norm"], gated, cfg.norm_eps)
    return row_einsum("bsm,md->bsd", gated, lp["wo"], 2, 0)


def mamba_sequence(
    lp: Params, x: torch.Tensor, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
    keep_tail: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """One Mamba2 block over a full sequence (residual outside).

    Returns (output, conv tail (B, W-1, conv_dim), final SSD state
    (B, H, P, N)): the reference's ``mamba_block`` without a cache and the
    cache derivation of its ``prefill`` bodies, in one pass.  The tail is a
    copy of the conv input's last rows (None without ``keep_tail``), so the
    whole conv input is freed with the layer.  The SSD goes through
    :func:`repro_torch.kernels.ops.ssd_scan`.
    """
    lp = gather_fsdp(lp, policy)
    u = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
    z, xin, b_in, c_in, dt_raw = _in_proj(lp, u)
    w, di, n = cfg.ssm_conv_width, cfg.ssm_d_inner, cfg.ssm_state
    if is_dtensor(xin):
        # Depthwise: on a mesh x's channels (split) are convolved apart from
        # B's and C's, since one concatenation would gather x.
        bc = torch.cat([b_in, c_in], dim=-1)  # (B,S,2N)
        tail = torch.cat([xin[:, -(w - 1):], bc[:, -(w - 1):]], dim=-1) if keep_tail else None
        k_x, k_bc = torch.split(lp["conv"], [di, 2 * n], dim=1)
        x_conv, (b_ssd, c_ssd) = silu_conv(xin, k_x), torch.split(silu_conv(bc, k_bc), n, dim=-1)
    else:
        # One conv pass: half the per-tap launches of two.
        conv_in = torch.cat([xin, b_in, c_in], dim=-1)  # (B,S,di+2N)
        tail = conv_in[:, -(w - 1):, :].clone() if keep_tail else None
        x_conv, b_ssd, c_ssd = torch.split(silu_conv(conv_in, lp["conv"]), [di, n, n], dim=-1)
    xh, dt, a = _ssd_inputs(lp, x_conv, dt_raw, cfg)
    xh = shard_act(xh, policy, "batch", None, "model", None)
    y, final = ops.ssd_scan(xh, dt, a, b_ssd, c_ssd, cfg.ssm_chunk)
    out = _gate_out(lp, y, xh, z, cfg)
    return shard_act(out, policy, "batch", None, None), tail, final


def mamba_block(
    params: Params,
    x: torch.Tensor,             # (B, S, D)
    cfg: ModelConfig,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (conv, state)
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Apply one Mamba2 block (pre-norm, residual outside).

    Training/prefill: ``cache=None`` -> chunked SSD over the sequence.
    Decode: ``cache=(conv_cache, ssd_state)`` and S == 1; returns the new
    (conv_cache, ssd_state).
    """
    if cache is None:
        out, _tail, _final = mamba_sequence(params, x, cfg, policy, keep_tail=False)
        return out, None
    if x.shape[1] != 1:
        raise ValueError(f"a Mamba2 decode step takes one token, got {x.shape[1]}")
    params = gather_fsdp(params, policy)
    u = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    z, xin, b_in, c_in, dt_raw = _in_proj(params, u)
    conv_in = torch.cat([xin, b_in, c_in], dim=-1)
    conv_cache, ssd_state = cache
    conv_t, conv_cache = causal_conv_step(conv_cache, conv_in[:, 0], params["conv"])
    conv_t = F.silu(conv_t.float()).to(conv_in.dtype)
    x1, b1, c1 = torch.split(conv_t[:, None], [cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_state],
                             dim=-1)
    xh, dt, a = _ssd_inputs(params, x1, dt_raw, cfg)
    y1, ssd_state = ssd_decode_step(ssd_state, xh[:, 0], dt[:, 0], a, b1[:, 0], c1[:, 0])
    out = _gate_out(params, y1[:, None], xh, z, cfg)
    return shard_act(out, policy, "batch", None, None), (conv_cache, ssd_state)


# --------------------------------------------------------------------------
# Full SSM model (mamba2-780m)
# --------------------------------------------------------------------------

def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise ValueError(f"models.ssm runs the ssm family, not {cfg.family!r}")


def init(generator: torch.Generator, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """Parameters on ``device`` (``cuda`` unless the caller names another),
    drawn from ``generator``."""
    _check_family(cfg)
    dev = resolve_device(device)
    return {
        "embed": L.init_embed(generator, cfg, dev),
        "layers": draw_stacked(lambda: init_mamba_block(generator, cfg, dev), cfg.num_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.params_dtype(), dev),
    }


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> Params:
    return {
        "embed": L.spec_embed(cfg, policy),
        "layers": stacked_specs(spec_mamba_block(cfg, policy)),
        "final_norm": L.spec_rmsnorm(),
    }


def forward(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, V) and a zero aux loss."""
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)

        def body(lp: Params, x: torch.Tensor) -> torch.Tensor:
            y, _ = mamba_block(lp, x, cfg, policy=policy)
            return x + y

        for i in range(num_stacked(params["layers"])):
            x = L.remat(cfg, body, layer_params(params["layers"], i), x)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(
    params: Params, tokens: Any, cfg: ModelConfig, policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, SSMCache]:
    """Prompt pass returning final logits + SSM state caches per layer: the
    cache is allocated once (on a mesh in ``ssm_cache_spec``'s layout) and
    each layer's conv tail and SSD state written into it as it finishes."""
    with on_mesh(params):
        tokens = token_ids(tokens, params, policy)
        x = L.embed_tokens(params["embed"], tokens, cfg, policy)
        n = num_stacked(params["layers"])
        cache = prefill_ssm_cache(cfg, tokens.shape, n, mesh_of(params), policy, x.device)
        for i in range(n):
            y, tail, final = mamba_sequence(layer_params(params["layers"], i), x, cfg, policy)
            x = x + y
            write_rows(cache.conv, 0, i, tail[None])
            write_rows(cache.state, 0, i, final[None])
            del y, tail, final  # else they live on through the next layer
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits[:, 0], cache


def prefill_ssm_cache(cfg: ModelConfig, token_shape: Tuple[int, int], layers: int, mesh: Any,
                      policy: ShardingPolicy, device: torch.device) -> SSMCache:
    """The SSM cache of a prefill over tokens of ``token_shape`` (B, S),
    allocated once for ``layers`` Mamba2 layers (on ``mesh``, if any, in
    ``ssm_cache_spec``'s layout): a prompt shorter than W - 1 keeps S conv
    rows, as the reference's tail slice does."""
    b, s = token_shape
    shapes = ssm_cache_shape(cfg, b, layers)
    shapes.conv = shapes.conv[:, :, :min(s, cfg.ssm_conv_width - 1)]
    return prefill_cache(shapes, ssm_cache_spec(cfg, policy), mesh, device)


def decode_step(
    params: Params,
    token: Any,                 # (B,) newest token ids
    cache: SSMCache,
    cache_len: int,             # unused (the state is a summary); interface parity
    cfg: ModelConfig,
    policy: ShardingPolicy = TP_POLICY,
) -> Tuple[torch.Tensor, SSMCache]:
    """One decode step: logits (B, V) + the cache, updated **in place**
    (every layer's conv window and SSD state) and returned — the reference
    returns an updated copy."""
    with on_mesh(params):
        token = token_ids(token, params, policy)
        x = L.embed_tokens(params["embed"], token[:, None], cfg, policy)
        for i in range(num_stacked(params["layers"])):
            y, (conv, state) = mamba_block(
                layer_params(params["layers"], i), x, cfg,
                cache=(cache.conv[i], cache.state[i]), policy=policy,
            )
            write_rows(cache.conv, 0, i, conv[None])
            write_rows(cache.state, 0, i, state[None])
            x = x + y
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.unembed(params["embed"], x, cfg, policy)
        return logits[:, 0], cache
