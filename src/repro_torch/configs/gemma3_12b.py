"""Gemma 3 12B — 5:1 local:global attention, qk-norm, 128k context.

[hf:google/gemma-3-12b-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    qk_norm=True,
    post_norm=True,
    sliding_window=1024,
    local_global_pattern=(5, 1),   # 5 local then 1 global per super-block
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    source="hf:google/gemma-3-1b-pt scaled; unverified",
)
