"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT frontend (stub patch
embeddings) + InternLM2-20B-style LM backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553,  # padded to 92672
    vision_tokens=256,             # stub InternViT pixel-unshuffled tokens
    rope_theta=1e6, act="swiglu",
)
