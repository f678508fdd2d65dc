"""Whisper-base [arXiv:2212.04356] — enc-dec; conv/mel frontend is a stub
(input_specs provides precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, enc_seq=1500,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,   # padded to 51968 for TP divisibility
    act="gelu",
)
