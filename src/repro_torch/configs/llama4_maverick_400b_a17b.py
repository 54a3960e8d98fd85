"""Llama 4 Maverick 400B-A17B — interleaved MoE (every 2nd layer), 128 experts
top-1 + shared expert, early-fusion multimodal (frontend out of scope here).

Interpretation note (config marked unverified upstream): a flat 48x128-expert
reading yields ~780B params, contradicting the 400B name; interleaved MoE every
2 layers with a shared expert matches 400B total / ~17B active, as in the
released Llama-4 family (interleave_moe_layer_step=2).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, expert_d_ff=8192,
                  moe_every_n=2, shared_expert_d_ff=8192),
    skip_shapes=("long_500k",),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
