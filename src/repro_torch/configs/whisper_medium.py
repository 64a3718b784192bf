"""whisper-medium — OpenAI Whisper medium enc-dec [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a STUB: input_specs delivers
(B, T, 80) frame features; the 24+24 layer transformer is fully implemented.
"""
from repro_torch.models.config import make_config

CONFIG = make_config(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,  # padded to 51968 for the model axis
    head_dim=64, activation="gelu",
    enc_layers=24, enc_inputs=80,
    citation="arXiv:2212.04356 (Whisper)",
)

SMOKE = make_config(
    name="whisper-medium-smoke", family="encdec",
    num_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=1024, head_dim=32, activation="gelu",
    enc_layers=2, enc_inputs=80,
    dtype="float32", param_dtype="float32",
    remat=False, attn_chunk=64, loss_chunk=32,
    citation="reduced whisper-medium",
)
