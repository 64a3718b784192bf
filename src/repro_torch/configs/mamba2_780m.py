"""mamba2-780m — Mamba2 780M, SSD state-space duality [arXiv:2405.21060]."""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,  # attention-free
    d_ff=0, vocab_size=50280,  # padded to 50432 for the model axis
    head_dim=64,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=64, ssm_expand=2,  # chunk 256->64: Perf A1
    citation="arXiv:2405.21060 (Mamba2 / SSD)",
)

SMOKE = make_config(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=128, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=1024, head_dim=32,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=32, ssm_expand=2,
    dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced mamba2",
)
