"""InternVL2 26B — InternViT vision frontend + InternLM2-20B language backbone.

The InternViT patch-embedding frontend is a STUB per the task spec:
input_specs() provides precomputed patch/text embeddings (B, S, d_model).
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,   # padded to 92672 for TP sharding (loss masks pads)
    input_mode="embeddings",
    skip_shapes=("long_500k",),
    source="arXiv:2404.16821; hf",
)
