"""Config system: model/shape dataclasses + the architecture registry.

A copy of the JAX package's ``repro.configs.base``, kept in the port so that
the port imports nothing of the JAX package. Every assigned architecture is a
frozen ``ModelConfig``; ``reduced()`` derives the family-preserving smoke-test
variant. Fields that only the JAX package reads (``use_pallas``,
``attn_impl``, ``ssd_impl``, ``remat_policy``) are kept so the two config
objects stay field-for-field comparable.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set; identical across LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    moe_every_n: int = 1          # MoE layer every n-th block (llama4: 2)
    shared_expert_d_ff: int = 0   # llama4 shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # "dense" | "moe" | "ssm" | "hybrid"
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (unused for pure-ssm)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    qkv_bias: bool = False
    attn_softcap: float = 0.0     # gemma2: 50.0
    final_softcap: float = 0.0    # gemma2: 30.0
    qk_norm: bool = False         # gemma3
    post_norm: bool = False       # gemma2/3 post-sublayer norms
    sliding_window: int = 0       # local-attention window (gemma2: 4096, gemma3: 1024)
    # pattern of (local, global) attention layers per super-block; None = all global
    local_global_pattern: Optional[Tuple[int, int]] = None
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3 global layers use 1e6
    # moe / ssm / hybrid extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0    # zamba2: shared attention block cadence
    # modality
    input_mode: str = "tokens"    # "tokens" | "embeddings" (musicgen/internvl stubs)
    # numerics / execution
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    use_pallas: bool = False      # flips hot paths to Pallas kernels on TPU
    # "jnp" = reference lowering; "fused_proxy" = DRY-RUN-ONLY stand-in with
    # identical dot shapes/FLOPs but no f32 softmax/decay chains, used to
    # lower the memory roofline the way the Pallas kernels do on real TPU
    # (CPU cannot lower pallas_call). Never used for numerics.
    attn_impl: str = "jnp"
    ssd_impl: str = "chunked"
    remat_policy: str = "full"    # "none" | "minimal" | "full"
    # which shapes are runnable (long_500k skipped for pure full-attention archs)
    skip_shapes: Tuple[str, ...] = ()
    source: str = ""

    # -- derived ---------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def attn_dims_ok(self) -> bool:
        return self.num_heads > 0

    def runnable_shapes(self) -> list[str]:
        return [s for s in SHAPES if s not in self.skip_shapes]

    # -- parameter accounting (for 6ND roofline term) ---------------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.qkv_bias:
        p += (h + 2 * kv) * hd
    return p


def _mlp_params(d: int, ff: int) -> int:
    return 3 * d * ff  # gated (wi, wg, wo)


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d, di = cfg.d_model, s.d_inner(cfg.d_model)
    nh = s.num_heads(cfg.d_model)
    # in_proj: z, x, B, C, dt ; out_proj ; conv ; A, D, dt_bias, norm
    in_proj = d * (2 * di + 2 * s.d_state + nh)
    out_proj = di * d
    conv = s.conv_width * (di + 2 * s.d_state)
    extras = 3 * nh + di
    return in_proj + out_proj + conv + extras


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    norms = 2 * d
    total = cfg.padded_vocab * d  # embedding (tied output head)
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d
    if cfg.family == "ssm":
        total += cfg.num_layers * (_ssm_params(cfg) + d)
        return total + d
    if cfg.family == "hybrid":
        total += cfg.num_layers * (_ssm_params(cfg) + d)
        # one shared attention+mlp block
        total += _attn_params(cfg) + _mlp_params(d, cfg.d_ff) + norms
        return total + d
    per_layer_attn = _attn_params(cfg) + norms
    if cfg.family == "dense":
        total += cfg.num_layers * (per_layer_attn + _mlp_params(d, cfg.d_ff))
        return total + d
    # moe
    m = cfg.moe
    n_moe = cfg.num_layers // m.moe_every_n
    n_dense = cfg.num_layers - n_moe
    total += cfg.num_layers * per_layer_attn
    total += n_dense * _mlp_params(d, cfg.d_ff)
    router = d * m.num_experts
    shared = _mlp_params(d, m.shared_expert_d_ff) if m.shared_expert_d_ff else 0
    experts_all = m.num_experts * _mlp_params(d, m.expert_d_ff)
    experts_act = m.top_k * _mlp_params(d, m.expert_d_ff)
    total += n_moe * (router + shared + (experts_act if active_only else experts_all))
    return total + d


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants: same family/features, tiny sizes
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny variant for CPU smoke tests."""
    changes: dict = dict(
        d_model=64,
        vocab_size=503,            # deliberately non-multiple to exercise padding
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        sliding_window=32 if cfg.sliding_window else 0,
        use_pallas=False,
        remat_policy="none",
    )
    if cfg.local_global_pattern is not None:
        lp, gp = cfg.local_global_pattern
        changes["num_layers"] = 2 * (lp + gp)
    elif cfg.shared_attn_every:
        changes["num_layers"] = 2 * cfg.shared_attn_every + 2
        changes["shared_attn_every"] = cfg.shared_attn_every
    elif cfg.moe is not None:
        changes["num_layers"] = 2 * cfg.moe.moe_every_n
    else:
        changes["num_layers"] = 2
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), expert_d_ff=64,
            shared_expert_d_ff=64 if cfg.moe.shared_expert_d_ff else 0,
            capacity_factor=4.0,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCHS = (
    "gemma2-27b",
    "qwen2-72b",
    "gemma3-12b",
    "yi-9b",
    "musicgen-medium",
    "internvl2-26b",
    "mamba2-370m",
    "zamba2-1.2b",
    "granite-moe-1b-a400m",
    "llama4-maverick-400b-a17b",
)

_MODULE_FOR = {
    "gemma2-27b": "gemma2_27b",
    "qwen2-72b": "qwen2_72b",
    "gemma3-12b": "gemma3_12b",
    "yi-9b": "yi_9b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-26b": "internvl2_26b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-1.2b": "zamba2_1_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) dry-run cell."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in cfg.runnable_shapes():
            cells.append((arch, shape))
    return cells
