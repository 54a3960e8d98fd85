"""Zamba2 1.2B — Mamba2 backbone + shared attention block.

38 mamba2 blocks; a single shared (attention+MLP) block is applied after every
6 mamba blocks (6 applications). The real model's per-invocation LoRA deltas on
the shared block are omitted (noted in DESIGN.md).
[arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk_size=256),
    shared_attn_every=6,
    source="arXiv:2411.15242; hf",
)
