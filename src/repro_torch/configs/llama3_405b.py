"""Llama3-405B [arXiv:2407.21783] — dense GQA kv=8, 128k vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    rope_theta=5e5, act="swiglu",
)
