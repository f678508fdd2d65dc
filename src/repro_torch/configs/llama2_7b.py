"""Llama2-7B — the paper's main FP4 experiment (Fig. 6, Table 3)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000,
    act="smooth_swiglu",   # paper setup: Smooth-SwiGLU [9]
)
