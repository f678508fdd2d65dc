"""Llama2-style 60M — the paper's threshold-validation scale (Fig. 5)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-60m", family="dense",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=1408, vocab_size=32000,
    act="smooth_swiglu",
)
