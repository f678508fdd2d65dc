"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention
block every 6 layers (MHA: kv == heads)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, n_ssm_heads=64,
    attn_every=6, act="swiglu",
)
