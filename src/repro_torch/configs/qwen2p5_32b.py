"""Qwen2.5-32B [hf:Qwen family] — dense GQA kv=8, QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, act="swiglu",
)
