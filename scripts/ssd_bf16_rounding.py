"""Where the bf16 SSD kernels may round, on the CPU.

    PYTHONPATH=src python scripts/ssd_bf16_rounding.py

The bf16 kernels of ``src/repro_torch/csrc/ssd_scan.cu`` feed three
computed operands to the tensor cores: x∘g of the chunk-state product, L of
the intra-chunk product and the state entering each chunk.  This script
emulates the kernels' arithmetic in fp32 PyTorch, rounding chosen operands
to bf16 (``bf16``) or to a bf16 hi + lo pair (``pair``), on one batch row
of each model prefill (mamba2-780m, zamba2-2.7b; seeded inputs as in
``chip_smoke.py``), and prints, for y and the final state, how many
outputs lie beyond the kernels' gate of 5e-2 abs + rel against the plain
version, ``models/ssm.py::ssd_chunked``.  About a minute; no GPU needed.
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.ssm import ssd_chunked

TOL = 5e-2
SHAPES = (("mamba2", 1, 2048, 48, 64, 128, 64, 0), ("zamba2", 1, 1024, 80, 64, 64, 256, 1))


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def pair(t: torch.Tensor) -> torch.Tensor:
    hi = bf16(t)
    return hi + bf16(t - hi)


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def emulate(x, dt, a, b_in, c_in, q, round_xg, round_l, round_h):
    """The three kernels' phases in fp32, with the given rounding of x∘g,
    of L and of the entering states."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    pad = (-s) % q
    x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
    b_in, c_in = F.pad(b_in, (0, 0, 0, pad)), F.pad(c_in, (0, 0, 0, pad))
    nc = x.shape[1] // q
    xf = x.float().reshape(bsz, nc, q, h, p)
    dtf = dt.reshape(bsz, nc, q, h)
    bf = b_in.float().reshape(bsz, nc, q, n)
    cf = c_in.float().reshape(bsz, nc, q, n)
    cum = torch.cumsum(dtf * a, 2)
    g = dtf * torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjhp,bcjn->bchpn", round_xg(xf * g[..., None]), bf)
    decay = torch.exp(cum[:, :, -1, :])
    state, entering = torch.zeros(bsz, h, p, n), []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + states[:, c]
    hp = torch.stack(entering, 1)
    cb = torch.einsum("bcin,bcjn->bcij", cf, bf)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, None, :, :, None]
    zero = torch.zeros(())
    lmat = torch.where(causal, torch.exp(torch.where(causal, diff, zero)), zero)
    lmat = lmat * cb[..., None] * dtf[:, :, None, :, :]
    y = (torch.einsum("bcijh,bcjhp->bcihp", round_l(lmat), xf)
         + torch.einsum("bcin,bchpn->bcihp", cf, round_h(hp)) * torch.exp(cum)[..., None])
    return y.reshape(bsz, nc * q, h, p)[:, :s].to(x.dtype), state


def inputs(b, s, h, p, n, seed):
    """x, B and C as views of one bf16 conv output; dt = softplus(normal),
    a = -exp(normal) in fp32."""
    rng = np.random.default_rng(seed)
    conv = torch.as_tensor(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    xin, bb, cc = torch.split(conv.bfloat16(), [h * p, n, n], dim=-1)
    dt = F.softplus(torch.as_tensor(rng.standard_normal((b, s, h)).astype(np.float32)))
    a = -torch.exp(torch.as_tensor(rng.standard_normal(h).astype(np.float32)))
    return xin.reshape(b, s, h, p), dt, a, bb, cc


def beyond(got: torch.Tensor, want: torch.Tensor) -> int:
    return int(((got.float() - want.float()).abs() > TOL * (1 + want.float().abs())).sum())


def main() -> None:
    cases = {"x∘g, L and h bf16": (bf16, bf16, bf16), "L bf16": (exact, bf16, exact),
             "x∘g bf16": (bf16, exact, exact), "h bf16": (exact, exact, bf16),
             "all pairs": (pair, pair, pair)}
    for name, b, s, h, p, n, q, seed in SHAPES:
        x, dt, a, bb, cc = inputs(b, s, h, p, n, seed)
        ry, rfin = ssd_chunked(x, dt, a, bb, cc, q)
        for label, rounding in cases.items():
            y, fin = emulate(x, dt, a, bb, cc, q, *rounding)
            print(json.dumps({"shape": name, "rounding": label, "outputs": ry.numel(),
                              "y_beyond": beyond(y, ry), "final_beyond": beyond(fin, rfin)}),
                  flush=True)


if __name__ == "__main__":
    main()
