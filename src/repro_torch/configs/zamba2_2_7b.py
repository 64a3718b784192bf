"""zamba2-2.7b — Zyphra Zamba2 2.7B hybrid: Mamba2 backbone + globally
shared attention blocks [arXiv:2411.15242]."""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,  # already a multiple of 256
    head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_chunk=256, ssm_expand=2,
    hybrid_attn_period=6,  # shared attention every 6 Mamba2 blocks
    citation="arXiv:2411.15242 (Zamba2)",
)

SMOKE = make_config(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=1024, head_dim=32,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=32, ssm_expand=2,
    hybrid_attn_period=2,
    dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced zamba2",
)
