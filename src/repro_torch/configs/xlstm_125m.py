"""xLSTM-125M [arXiv:2405.04517] — mLSTM blocks with every 4th sLSTM.
d_ff=0 per assignment: FFN width comes from proj_factor inside the blocks."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=4, proj_factor=2.0, act="swiglu",
)
