"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B scaled; hf] — 128 experts top-8,
GQA kv=4, qk-norm, per-expert d_ff=1536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    n_experts=128, top_k=8,
    moe_groups=16,   # GShard-style group-limited dispatch (DP-local sort)
    rope_theta=1e6, act="swiglu", use_qk_norm=True,
)
