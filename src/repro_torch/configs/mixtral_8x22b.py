"""mixtral-8x22b — Mistral Mixtral 8x22B (MoE top-2, sliding window)
[arXiv:2401.04088]."""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,  # GQA kv=8
    d_ff=16384, vocab_size=32768, head_dim=128,
    activation="swiglu", sliding_window=4096,
    moe_num_experts=8, moe_top_k=2, moe_num_shared_experts=0, moe_d_ff=16384,
    rope_theta=1e6,
    citation="arXiv:2401.04088 (Mixtral of Experts)",
)

SMOKE = make_config(
    name="mixtral-smoke", family="moe",
    num_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=1024, head_dim=32,
    activation="swiglu", sliding_window=32,
    moe_num_experts=4, moe_top_k=2, moe_num_shared_experts=0, moe_d_ff=256,
    dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=16, loss_chunk=32,
    citation="reduced mixtral",
)
