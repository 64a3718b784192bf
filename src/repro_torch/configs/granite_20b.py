"""granite-20b — IBM Granite 20B Code (llama-arch, MQA) [arXiv:2405.04324]."""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,  # MQA (kv=1)
    d_ff=24576, vocab_size=49152, head_dim=128,
    activation="swiglu", rope_theta=1e5,
    citation="arXiv:2405.04324 (Granite Code Models)",
)

SMOKE = make_config(
    name="granite-20b-smoke", family="dense",
    num_layers=2, d_model=192, n_heads=6, n_kv_heads=1,
    d_ff=384, vocab_size=1024, head_dim=32,
    activation="swiglu", dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced granite-20b",
)
