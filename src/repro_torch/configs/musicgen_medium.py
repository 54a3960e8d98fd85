"""MusicGen medium — decoder-only transformer over EnCodec audio tokens.

Modality frontend (EnCodec codebook embedding/delay pattern) is a STUB per the
task spec: input_specs() provides precomputed frame embeddings (B, S, d_model).
[arXiv:2306.05284; hf:facebook/musicgen-medium]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,   # MHA
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    input_mode="embeddings",
    skip_shapes=("long_500k",),
    source="arXiv:2306.05284; hf",
)
