"""nemotron-4-340b — NVIDIA Nemotron-4 340B (GQA, squared-ReLU)
[arXiv:2402.16819]."""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,  # GQA kv=8
    d_ff=73728, vocab_size=256000, head_dim=192,
    activation="squared_relu", rope_theta=1e4,
    citation="arXiv:2402.16819 (Nemotron-4)",
)

SMOKE = make_config(
    name="nemotron-smoke", family="dense",
    num_layers=2, d_model=384, n_heads=8, n_kv_heads=2,
    d_ff=1536, vocab_size=1024, head_dim=48,
    activation="squared_relu", dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced nemotron-4",
)
