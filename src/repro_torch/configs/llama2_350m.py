"""Llama2-style 350M — the paper's ablation scale (Figs. 1-3)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-350m", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=32000,
    act="smooth_swiglu",
)
