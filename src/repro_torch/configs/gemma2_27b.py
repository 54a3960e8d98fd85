"""Gemma 2 27B — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf:google/gemma-2-27b]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_softcap=50.0,
    post_norm=True,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=(1, 1),   # alternating local:global
    rope_theta=10_000.0,
    source="arXiv:2408.00118; hf",
)
