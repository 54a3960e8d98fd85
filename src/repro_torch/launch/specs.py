"""Abstract arguments of every step kind (train, prefill, decode) for
every (arch x shape), from the JAX package's ``repro.launch.specs``:
meta-device tensors (shapes and dtypes, no storage, JAX's
``ShapeDtypeStruct``s) paired with their specs under a ``ShardingPolicy``.
Launch-time code reuses the specs to place real tensors
(``ShardingPolicy.placements``; a model built under the policy places its
params and caches itself: ``model.distribute``, ``model.init_cache``).

``make_policy``, ``abstract_params``, ``abstract_opt_state`` (f32, bf16
and int8 moments), ``abstract_cache``, ``batch_specs``, ``decode_specs``
and ``input_specs`` for the three kinds. JAX's ``_with_shardings`` has no
counterpart: a spec travels beside its meta tensor instead of inside it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import Parallelism, ShardingPolicy
from repro_torch.models.layers import MetaGenerator
from repro_torch.optim.adamw import tree_map


def make_policy(cfg: ModelConfig, shape: ShapeConfig, mesh,
                pipeline: bool = False):
    """(policy, parallel) for ``cfg`` at ``shape`` on ``mesh`` (an
    ``AbstractMesh`` or a DeviceMesh); ``long_500k`` shards the KV cache's
    sequence (JAX's)."""
    parallel = Parallelism.for_mesh(mesh, pipeline=pipeline)
    policy = ShardingPolicy(cfg, mesh, parallel, kind=shape.kind,
                            shard_seq_kv=shape.name == "long_500k")
    return policy, parallel


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(model, policy: ShardingPolicy):
    """(params as meta tensors, their axes, their specs): the model's init
    drawn on the meta device, no storage at any width."""
    params = model.init(MetaGenerator())
    axes = model.axes()
    return params, axes, policy.tree_specs(params, axes)


def abstract_opt_state(params, axes, policy: ShardingPolicy,
                       moment_dtype: str = "float32"):
    """(AdamW state as meta tensors, its specs): moments like the params
    in ``moment_dtype`` and the params' specs; int8 moments with a
    replicated f32 scale a leaf; a replicated int32 step count."""
    rep = ()
    count = _meta((), torch.int32)
    if moment_dtype == "int8":
        m = tree_map(lambda p: _meta(p.shape, torch.int8), params)
        sc = tree_map(lambda p: _meta((), torch.float32), params)
        sh = policy.tree_specs(m, axes)
        sc_sh = tree_map(lambda p: rep, params)
        return ({"m": m, "m_scale": sc, "v": m, "v_scale": sc,
                 "count": count},
                {"m": sh, "m_scale": sc_sh, "v": sh, "v_scale": sc_sh,
                 "count": rep})
    mdt = getattr(torch, moment_dtype)
    m = tree_map(lambda p: _meta(p.shape, mdt), params)
    sh = policy.tree_specs(m, axes)
    return {"m": m, "v": m, "count": count}, {"m": sh, "v": sh, "count": rep}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                policy: ShardingPolicy):
    """A training or prefill batch, inputs and labels, as ``{name: (meta
    tensor, spec)}``."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings":
        inputs = (_meta((b, s, cfg.d_model), getattr(torch, cfg.dtype)),
                  policy.spec((b, s, cfg.d_model), ("batch", "seq", "act")))
    else:
        inputs = (_meta((b, s), torch.int32),
                  policy.spec((b, s), ("batch", "seq")))
    labels = (_meta((b, s), torch.int32),
              policy.spec((b, s), ("batch", "seq")))
    return {"inputs": inputs, "labels": labels}



def abstract_cache(model, policy: ShardingPolicy, batch: int, max_seq: int):
    """(caches as meta tensors, their axes, their specs): the model's
    ``init_cache`` on the meta device."""
    caches = model.init_cache(batch, max_seq, cache_device="meta")
    axes = model.cache_axes()
    return caches, axes, policy.tree_specs(caches, axes)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 policy: ShardingPolicy):
    """Single-token decode inputs: ((inputs, spec), (pos, spec)), inputs
    (B, 1) token ids or (B, 1, d) embeddings, pos (B,) int32."""
    b = shape.global_batch
    if cfg.input_mode == "embeddings":
        inputs = (_meta((b, 1, cfg.d_model), getattr(torch, cfg.dtype)),
                  policy.spec((b, 1, cfg.d_model), ("batch", "seq", "act")))
    else:
        inputs = (_meta((b, 1), torch.int32),
                  policy.spec((b, 1), ("batch", "seq")))
    pos = (_meta((b,), torch.int32), policy.spec((b,), ("batch",)))
    return inputs, pos


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                policy: ShardingPolicy, model):
    """Every abstract input of the step ``shape`` runs, as JAX's:

      train   -> (state, batch)
      prefill -> (params, batch inputs)
      decode  -> (params, caches, inputs, pos)

    Returns (args, aux): args as meta tensors (a batch or decode input as
    its (meta tensor, spec) pair, as ``batch_specs``), aux the specs and
    axes JAX returns for its out-shardings (``state_sh`` and
    ``moment_dtype``; ``params_sh``; ``cache_sh`` and ``cache_axes``; and
    ``axes``)."""
    params, axes, params_sh = abstract_params(model, policy)
    if shape.kind == "train":
        mdt = "bfloat16" if cfg.param_count() > 1e11 else "float32"
        opt, opt_sh = abstract_opt_state(params, axes, policy, mdt)
        return ({"params": params, "opt": opt},
                batch_specs(cfg, shape, policy)), {
                    "state_sh": {"params": params_sh, "opt": opt_sh},
                    "moment_dtype": mdt, "axes": axes}
    if shape.kind == "prefill":
        return (params, batch_specs(cfg, shape, policy)["inputs"]), {
            "params_sh": params_sh, "axes": axes}
    caches, cache_axes, cache_sh = abstract_cache(
        model, policy, shape.global_batch, shape.seq_len)
    inputs, pos = decode_specs(cfg, shape, policy)
    return (params, caches, inputs, pos), {
        "params_sh": params_sh, "cache_sh": cache_sh, "axes": axes,
        "cache_axes": cache_axes}
