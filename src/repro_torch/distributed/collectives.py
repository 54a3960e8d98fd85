"""Int8 error-feedback gradient compression for the cross-pod reduction,
ported from the JAX package's ``repro.distributed.collectives`` (the slow
inter-pod links are the scarce resource at 1000+ nodes).

Scheme (the EF-SGD / 1-bit-Adam family):
  * q = round(g / scale) clipped to int8, scale = max|g| / 127 per leaf
    (``torch.round`` rounds half to even, as ``jnp.round``);
  * the residual e = g - q*scale is fed back into the next step's gradient;
  * the reduction over the pod axis moves int8 values, summed as int32
    (4x fewer bytes than f32 on a wire that carries int8), and one f32 scale
    a leaf, reduced by MAX.

``compressed_pod_psum`` is JAX's ``shard_map`` over the pod axis: code on
each rank's local tensors with explicit collectives on the pod sub-group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import comm
from repro_torch.optim.adamw import tree_map


def quantize_int8(g, scale=None):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    g32 = g.to(torch.float32)
    if scale is None:
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, residuals):
    """Error-feedback compression: (q_tree, scales, new_residuals)."""
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                             grads)
    corrected = tree_map(lambda g, e: g.to(torch.float32) + e, grads,
                         residuals)
    qs = tree_map(quantize_int8, corrected)
    q_tree = tree_map(lambda c, t: t[0], corrected, qs)
    scales = tree_map(lambda c, t: t[1], corrected, qs)
    new_resid = tree_map(lambda c, q, s: c - dequantize_int8(q, s),
                         corrected, q_tree, scales)
    return q_tree, scales, new_resid


def compressed_pod_psum(grads, residuals, mesh, pod_axis: str = "pod"):
    """Mean-reduce gradients over the pod axis with an int8 wire format and
    error feedback. ``grads`` (a tree of tensors, each rank's own value of
    each leaf, already reduced within its pod) lie on this rank of
    ``mesh``. Returns (reduced grads f32, new residuals), each rank's.

    Each leaf's scale is its largest magnitude over the whole leaf: a
    DTensor leaf, sharded within the pod, takes a MAX over the mesh's other
    axes first (JAX's ``shard_map`` over the pod axis alone sees the
    leaf whole)."""
    group = comm.axis_group(mesh, pod_axis)
    npods = comm.group_size(group)
    others = [n for n in mesh.mesh_dim_names if n != pod_axis]

    def one(g, e):
        from torch.distributed.tensor import DTensor
        is_dt = isinstance(g, DTensor)
        local = g.to_local() if is_dt else g
        e_loc = e.to_local() if isinstance(e, DTensor) else e
        corrected = local.to(torch.float32) + e_loc
        top = corrected.abs().max()
        if is_dt:
            for name in others:
                comm.all_reduce(top, comm.axis_group(mesh, name),
                                dist.ReduceOp.MAX)
        q, scale = quantize_int8(corrected,
                                 torch.clamp(top, min=1e-12) / 127.0)
        # the int8 payload summed as int32; the scalar scales by MAX
        q_sum = comm.all_reduce(q.to(torch.int32), group)
        scale_max = comm.all_reduce(scale.clone(), group, dist.ReduceOp.MAX)
        reduced = q_sum.to(torch.float32) * scale_max / npods
        new_e = corrected - dequantize_int8(q, scale)
        if is_dt:
            reduced, new_e = (DTensor.from_local(t, g.device_mesh,
                                                 g.placements, shape=g.shape,
                                                 stride=g.stride())
                              for t in (reduced, new_e))
        return reduced, new_e

    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                             grads)
    pairs = tree_map(one, grads, residuals)
    return (tree_map(lambda g, p: p[0], grads, pairs),
            tree_map(lambda g, p: p[1], grads, pairs))
