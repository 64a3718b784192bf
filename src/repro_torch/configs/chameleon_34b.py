"""chameleon-34b — Meta Chameleon early-fusion VLM [arXiv:2405.09818].

Early fusion: image content arrives as VQ-VAE token ids inside the same
65536-entry vocabulary, so the backbone is a plain decoder; the VQ image
tokenizer frontend is a stub per the brief.
"""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,  # GQA kv=8
    d_ff=22016, vocab_size=65536, head_dim=128,
    activation="swiglu", rope_theta=1e4,
    citation="arXiv:2405.09818 (Chameleon)",
)

SMOKE = make_config(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=1024, head_dim=32,
    activation="swiglu", dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced chameleon-34b",
)
