"""Granite 3.0 1B-A400M — 32-expert top-8 MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,   # padded to 49408 for TP sharding
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512),
    skip_shapes=("long_500k",),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
