"""Small CNNs for the paper-scale experiments (LeNet-class, §6 Table 2),
the PyTorch port of ``repro.models.cnn``.

The public functions keep the reference's layout — NHWC activations, HWIO
conv weights, dense ``x @ w + b`` — so parameters carry over from the JAX
package unchanged.  Inside, convolution and pooling permute to NCHW / OIHW
for ``F.conv2d`` and ``F.max_pool2d``.  Blocks are row-wise over their
leading (sample) axis, which is what lets the executor fold a request group
into that axis.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import BlockCost

Params = Dict[str, Any]
BlockInit = Callable[[torch.Generator, torch.device], Params]
BlockApply = Callable[[Params, torch.Tensor], torch.Tensor]


def conv2d(params: Params, x: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv + bias.  x: (B, H, W, C); w: (3, 3, Cin, Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + params["b"]


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 VALID max-pool, stride 2, of an NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    # The paper's C library implements leaky ReLU (§5.2).
    return F.leaky_relu(x, negative_slope=0.01)


def _truncated_normal(
    generator: torch.Generator, shape: Tuple[int, ...], std: float,
    device: torch.device,
) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn on the
    CPU from ``generator`` (so a seed gives the same weights on any device)."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (std * t).to(device)


def _conv_init(generator: torch.Generator, device: torch.device, cin: int, cout: int) -> Params:
    std = 1.0 / math.sqrt(9 * cin)
    return {
        "w": _truncated_normal(generator, (3, 3, cin, cout), std, device),
        "b": torch.zeros((cout,), device=device),
    }


def _dense_init(generator: torch.Generator, device: torch.device, din: int, dout: int) -> Params:
    std = 1.0 / math.sqrt(din)
    return {
        "w": _truncated_normal(generator, (din, dout), std, device),
        "b": torch.zeros((dout,), device=device),
    }


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def build_lenet5_blocks(
    input_hw: Tuple[int, int, int] = (28, 28, 1),
    channels: Sequence[int] = (8, 16),
    dense_dims: Sequence[int] = (64, 32),
    num_blocks: int = 4,
) -> Tuple[List[BlockInit], List[BlockApply], List[BlockCost], int]:
    """The paper's 5-layer CNN cut into ``num_blocks`` task-graph blocks.

    Returns (block_inits, block_applies, per-block costs, feature_dim); an
    init takes ``(generator, device)``.  Block layout for the default 4
    blocks (3 branch points, §5.3/§7):
      B0: conv1+pool, B1: conv2+pool+flatten, B2: dense1, B3: dense2.
    """
    if num_blocks != 4:
        raise ValueError("the paper-scale CNN is fixed at 4 blocks (3 BPs)")
    h, w, cin = input_hw
    c1, c2 = channels
    d1, d2 = dense_dims
    h2, w2 = h // 2, w // 2
    h4, w4 = h2 // 2, w2 // 2
    flat = h4 * w4 * c2

    inits: List[BlockInit] = [
        lambda g, dev: _conv_init(g, dev, cin, c1),
        lambda g, dev: _conv_init(g, dev, c1, c2),
        lambda g, dev: _dense_init(g, dev, flat, d1),
        lambda g, dev: _dense_init(g, dev, d1, d2),
    ]

    def apply0(p, x):
        return maxpool2(leaky_relu(conv2d(p, x)))

    def apply1(p, x):
        # Flatten in NHWC order, as the reference does: dense1's rows follow it.
        y = maxpool2(leaky_relu(conv2d(p, x)))
        return y.reshape(y.shape[0], -1)

    def apply2(p, x):
        return leaky_relu(dense(p, x))

    def apply3(p, x):
        return leaky_relu(dense(p, x))

    applies: List[BlockApply] = [apply0, apply1, apply2, apply3]

    # Per-sample costs: weights in bytes (fp32), FLOPs = 2 * MACs.
    costs = [
        BlockCost(
            weight_bytes=4.0 * (9 * cin * c1 + c1),
            flops=2.0 * 9 * cin * c1 * h * w,
            act_bytes=4.0 * h2 * w2 * c1,
        ),
        BlockCost(
            weight_bytes=4.0 * (9 * c1 * c2 + c2),
            flops=2.0 * 9 * c1 * c2 * h2 * w2,
            act_bytes=4.0 * flat,
        ),
        BlockCost(
            weight_bytes=4.0 * (flat * d1 + d1),
            flops=2.0 * flat * d1,
            act_bytes=4.0 * d1,
        ),
        BlockCost(
            weight_bytes=4.0 * (d1 * d2 + d2),
            flops=2.0 * d1 * d2,
            act_bytes=4.0 * d2,
        ),
    ]
    return inits, applies, costs, d2


def head_init(
    generator: torch.Generator, feat_dim: int, num_classes: int,
    device: torch.device,
) -> Params:
    return _dense_init(generator, device, feat_dim, num_classes)


def head_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return dense(params, x)
