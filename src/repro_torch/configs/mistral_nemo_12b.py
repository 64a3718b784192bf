"""mistral-nemo-12b — Mistral-Nemo-Base-2407, 128k context
[hf:mistralai/Mistral-Nemo-Base-2407].

Full attention natively; ``long_context_window`` enables the beyond-paper
sliding-window variant used only for the long_500k decode shape (DESIGN §5).
"""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,  # GQA kv=8
    d_ff=14336, vocab_size=131072, head_dim=160,
    activation="swiglu", rope_theta=1e6,
    long_context_window=4096,
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = make_config(
    name="mistral-nemo-smoke", family="dense",
    num_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=1024, head_dim=32,
    activation="swiglu", dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced mistral-nemo",
)
