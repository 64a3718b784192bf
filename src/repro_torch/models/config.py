"""Model configuration shared by every architecture family, the PyTorch
port of ``repro.models.config``.

One dataclass covers all 10 architectures of the zoo (dense / MoE / SSM /
hybrid / encoder-decoder / VLM); family-specific fields are simply unused by
other families.  Every config in :mod:`repro_torch.configs` cites its source
paper/model card.  The only change from the reference: the dtype accessors
return ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple so it shards evenly over the model axis."""
    return ((v + multiple - 1) // multiple) * multiple


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    Attributes:
      name: architecture id (e.g. ``granite-34b``).
      family: ``dense | moe | ssm | hybrid | encdec | vlm``.
      num_layers: decoder layers (for encdec: decoder layers).
      d_model / n_heads / n_kv_heads / d_ff / vocab_size: usual dims.
        ``vocab_size`` is already padded; ``raw_vocab_size`` records the
        source value.
      head_dim: defaults to d_model // n_heads.
      activation: ``swiglu | gelu | squared_relu`` (nemotron uses
        squared-ReLU per arXiv:2402.16819).
      sliding_window: window size for SWA layers; None = full attention.
      moe_*: MoE routing parameters.  ``moe_d_ff`` is the per-expert hidden
        dim.
      ssm_*: Mamba2/SSD parameters (state size, head dim, chunk length).
      hybrid_attn_period: a shared attention block is applied every this
        many Mamba2 blocks (Zamba2-style globally-shared block).
      enc_layers / enc_inputs: encoder depth and frontend embedding width
        for enc-dec (whisper).
      dtype: activation/computation dtype; params kept in ``param_dtype``.
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    raw_vocab_size: int
    head_dim: int
    activation: str = "swiglu"
    sliding_window: Optional[int] = None
    # Sliding window applied ONLY for the long_500k shape (the beyond-paper
    # SWA variant that makes a full-attention arch long-context capable).
    long_context_window: Optional[int] = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- MoE ---
    moe_num_experts: int = 0
    moe_real_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv_width: int = 4

    # --- hybrid (Zamba2) ---
    hybrid_attn_period: int = 6
    hybrid_lora_rank: int = 16

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_inputs: int = 80

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024  # KV-block size of the reference's chunked attention
    loss_chunk: int = 512   # sequence chunk for the vocab-sharded CE loss

    citation: str = ""

    # ------------------------------------------------------------- derived
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic per-token decode: SSM, hybrid, or sliding-window."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
            or self.long_context_window is not None
        )

    def activation_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    def params_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def validate(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm" and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.family == "moe" and not (self.moe_num_experts > 0 and self.moe_top_k > 0):
            raise ValueError("a MoE config needs experts and top_k")
        if self.family in ("ssm", "hybrid"):
            if self.ssm_state <= 0 or self.ssm_d_inner % self.ssm_head_dim != 0:
                raise ValueError("bad SSM dimensions")
        if self.family == "encdec" and self.enc_layers <= 0:
            raise ValueError("an encdec config needs encoder layers")
        if self.vocab_size % 256 != 0:
            raise ValueError("vocab must be padded (pad_vocab)")


def make_config(**kw) -> ModelConfig:
    """Helper that applies vocab padding + default head_dim, then validates."""
    raw_vocab = kw.pop("vocab_size")
    kw.setdefault("raw_vocab_size", raw_vocab)
    kw["vocab_size"] = pad_vocab(raw_vocab)
    if "head_dim" not in kw or kw["head_dim"] is None:
        kw["head_dim"] = kw["d_model"] // max(kw.get("n_heads", 1), 1)
    cfg = ModelConfig(vocab_size=kw.pop("vocab_size"), **kw)
    cfg.validate()
    return cfg


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def get_shape(name: str) -> InputShape:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have {[s.name for s in INPUT_SHAPES]}")
