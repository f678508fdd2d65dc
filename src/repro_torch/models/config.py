"""Model architecture configuration (own copy of repro.models.config)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None      # SWA (mixtral)
    rope_theta: float = 10000.0
    act: str = "smooth_swiglu"                # smooth_swiglu | swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quantize_lm_head: bool = True             # paper: *all* GEMMs in FP4
    use_qk_norm: bool = False                 # qwen3-style q/k RMSNorm

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # group-limited (GShard-style) dispatch: tokens routed in G independent
    # groups pinned to the DP axis -> dispatch sort/scatter is shard-local.
    # 0 = one global group (smoke default); production configs set 16.
    moe_groups: int = 0

    # hybrid (zamba2): mamba2 backbone + one *shared* attention block applied
    # every `attn_every` layers; ssm params
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0
    n_ssm_heads: int = 0

    # xLSTM: every `slstm_every`-th block is sLSTM, the rest mLSTM
    slstm_every: int = 0
    proj_factor: float = 2.0

    # enc-dec (whisper): encoder depth; frontend supplies frame embeddings
    enc_layers: int = 0
    enc_seq: int = 1500

    # vlm (internvl2): stub patch-embedding prefix length
    vision_tokens: int = 0

    # attention chunking (flash-style) kicks in above this seq len
    attn_chunk: int = 1024

    # padded vocab for TP divisibility (set in __post_init__ consumers)
    vocab_pad_multiple: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers,
                         4 if (self.attn_every or self.slstm_every) else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            n_ssm_heads=min(self.n_ssm_heads, 4) if self.n_ssm_heads else 0,
            attn_every=2 if self.attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=32 if self.enc_layers else 0,
            vision_tokens=16 if self.vision_tokens else 0,
            sliding_window=64 if self.sliding_window else None,
            attn_chunk=64,
        )
