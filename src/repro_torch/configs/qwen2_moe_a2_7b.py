"""qwen2-moe-a2.7b — Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

4 always-on shared experts + 60 routed experts, top-4 routing; the shared
experts are the in-architecture mirror of Antler's shared task-graph blocks.
"""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="qwen2-moe-a2.7b", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    activation="swiglu",
    moe_num_experts=60, moe_top_k=4, moe_num_shared_experts=4, moe_d_ff=1408,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

# Expert-parallel variant (§Perf B5): 60 real experts padded to 64 so the
# expert axis shards over the 16-way model axis.
CONFIG_EP = make_config(
    name="qwen2-moe-a2.7b-ep", family="moe",
    num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151936, head_dim=128,
    activation="swiglu",
    moe_num_experts=64, moe_real_experts=60, moe_top_k=4,
    moe_num_shared_experts=4, moe_d_ff=1408,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B (padded for expert parallelism)",
)

SMOKE = make_config(
    name="qwen2-moe-smoke", family="moe",
    num_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=1024, head_dim=32,
    activation="swiglu",
    moe_num_experts=4, moe_top_k=2, moe_num_shared_experts=2, moe_d_ff=128,
    dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced qwen2-moe",
)
