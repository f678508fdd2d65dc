"""Mixtral 8x7B [arXiv:2401.04088; hf] — MoE 8 experts top-2, GQA kv=8, SWA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2,
    # moe_groups intentionally NOT set: measured on the dry-run, group-
    # limited dispatch HURTS the 8-expert case (t_coll 54->181 s on
    # prefill_32k: 16 per-group scatter buffers dwarf the small global
    # sort) while it is a 3.8x win for qwen3's 128 experts.  See
    # EXPERIMENTS.md §Perf iteration 5 (refuted hypothesis).
    sliding_window=4096,
    rope_theta=1e6, act="swiglu",
)
