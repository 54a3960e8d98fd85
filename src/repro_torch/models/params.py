"""Carry params and caches between the JAX package and the port as numpy.

The JAX models' param pytrees (the transformer's ``{"embed": {"tok"},
"blocks": [stacked per-sub dict], "final_norm"}``, the SSM's ``{"embed",
"mamba": {"ln", "mamba": {...}}, "final_norm"}``, the hybrid's SSM tree
with ``"shared"``, one unstacked sub dict) and caches (a list of ``{"k",
"v"}`` per sub, each (n_super, B, L, KV, hd) with L the window of a rolling
sub, else max_seq; the SSM's ``{"conv": {"x", "B", "C"}, "ssd"}`` stacked
on the layer axis; the hybrid's pair of the SSM's and a ``{"k", "v"}``
stacked on the shared block's applications) have the same
structure and layouts in the port, so the conversion is leaf by leaf and
exact: every leaf keeps its dtype, so the f32 leaves of a bf16 model
(``router``, ``A_log``, ``D``, ``dt_bias``, the SSD state) stay f32. The
caller turns JAX arrays into numpy (``jax.tree.map(np.asarray, tree)``); this
module never sees JAX. bfloat16 numpy arrays (``ml_dtypes.bfloat16``) cross
bit for bit. A train state (``{"params", "opt": {"m", "v", "count"[,
"m_scale", "v_scale"]}}``, moments in the params' structure) crosses the
same way with ``train_state_from_numpy`` / ``train_state_to_numpy``.
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
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _keys(tree):
    return set(tree) if isinstance(tree, dict) else None


def _check_params(tree):
    if _keys(tree) == {"embed", "blocks", "final_norm"}:
        return
    if _keys(tree) in ({"embed", "mamba", "final_norm"},
                       {"embed", "mamba", "shared", "final_norm"}) and \
            _keys(tree["mamba"]) == {"ln", "mamba"} and \
            isinstance(tree.get("shared", {}), dict):
        return
    raise ValueError("params must be {'embed', 'blocks', 'final_norm'}, "
                     "{'embed', 'mamba': {'ln', 'mamba'}, 'final_norm'} or "
                     "the latter with a 'shared' sub-layer dict")


def _ssm_caches(caches) -> bool:
    return _keys(caches) == {"conv", "ssd"} and \
        _keys(caches["conv"]) == {"x", "B", "C"}


def _check_caches(caches):
    if isinstance(caches, (list, tuple)) and all(
            _keys(c) == {"k", "v"} for c in caches):
        return
    if _ssm_caches(caches):
        return
    if isinstance(caches, tuple) and len(caches) == 2 and \
            _ssm_caches(caches[0]) and _keys(caches[1]) == {"k", "v"}:
        return
    raise ValueError("caches must be a list of {'k', 'v'} dicts, "
                     "{'conv': {'x', 'B', 'C'}, 'ssd'}, or a pair of the "
                     "latter and {'k', 'v'}")


def params_from_numpy(tree, device) -> dict:
    """JAX-layout numpy params -> the port's tensors on ``device``."""
    _check_params(tree)
    return _map(tree, lambda x: _leaf_to_torch(x, device))


def params_to_numpy(params) -> dict:
    _check_params(params)
    return _map(params, _leaf_to_numpy)


def caches_from_numpy(caches, device):
    _check_caches(caches)
    return _map(caches, lambda x: _leaf_to_torch(x, device))


def caches_to_numpy(caches):
    _check_caches(caches)
    return _map(caches, _leaf_to_numpy)


def to_device(tree, device):
    """Move a param or cache tree to ``device`` (no copy where it is
    already there; no leaf changes dtype)."""
    return _map(tree, lambda t: t.to(device))


_OPT_KEYS = ({"m", "v", "count"}, {"m", "v", "count", "m_scale", "v_scale"})


def _check_train_state(state):
    if _keys(state) != {"params", "opt"} or _keys(state["opt"]) not in \
            _OPT_KEYS:
        raise ValueError("a train state is {'params', 'opt': {'m', 'v', "
                         "'count'[, 'm_scale', 'v_scale']}}")
    _check_params(state["params"])
    for k in ("m", "v"):
        _check_params(state["opt"][k])


def train_state_from_numpy(state, device) -> dict:
    """A JAX-layout numpy train state -> the port's tensors on ``device``
    (0-dim leaves, the step count and int8 scales, too)."""
    _check_train_state(state)
    return _map(state, lambda x: _leaf_to_torch(x, device))


def train_state_to_numpy(state) -> dict:
    _check_train_state(state)
    return _map(state, _leaf_to_numpy)
