"""Carry params and caches between the JAX package and the port as numpy.

The JAX model's param pytree (``{"embed": {"tok"}, "blocks": [stacked
per-sub dict], "final_norm"}``) and cache list (``[{"k", "v"}]`` per sub, each
(n_super, B, max_seq, KV, hd)) have the same structure and layouts in the
port, so the conversion is leaf by leaf and exact. The caller turns JAX
arrays into numpy (``jax.tree.map(np.asarray, tree)``); this module never
sees JAX. bfloat16 numpy arrays (``ml_dtypes.bfloat16``) cross bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.array(x, order="C")    # a writable copy: caches are written
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # numpy's bfloat16 type, as JAX arrays use it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _check_params(tree):
    if not isinstance(tree, dict) or set(tree) != {"embed", "blocks",
                                                   "final_norm"}:
        raise ValueError("params must be {'embed', 'blocks', 'final_norm'}")


def _check_caches(caches):
    if not isinstance(caches, (list, tuple)) or not all(
            isinstance(c, dict) and set(c) == {"k", "v"} for c in caches):
        raise ValueError("caches must be a list of {'k', 'v'} dicts")


def params_from_numpy(tree, device) -> dict:
    """JAX-layout numpy params -> the port's tensors on ``device``."""
    _check_params(tree)
    return _map(tree, lambda x: _leaf_to_torch(x, device))


def params_to_numpy(params) -> dict:
    _check_params(params)
    return _map(params, _leaf_to_numpy)


def caches_from_numpy(caches, device) -> list:
    _check_caches(caches)
    return _map(caches, lambda x: _leaf_to_torch(x, device))


def caches_to_numpy(caches) -> list:
    _check_caches(caches)
    return _map(caches, _leaf_to_numpy)


def to_device(tree, device):
    """Move a param or cache tree to ``device`` (no copy where it is
    already there)."""
    return _map(tree, lambda t: t.to(device))
