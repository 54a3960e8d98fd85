"""Mamba2 370M — attention-free SSD (state-space duality).

d_inner = 2*d_model = 2048, headdim 64 -> 32 SSM heads, d_state 128.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    d_ff=0,
    vocab_size=50280,   # padded to 50432 for TP sharding
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    source="arXiv:2405.21060; unverified",
)
