"""Logical-axis sharding rules -> specs and DTensor placements, with
divisibility fallbacks; a port of the JAX package's
``repro.distributed.sharding``.

Weights and caches carry *logical* axis names (``model.axes()``); this
module maps them onto a mesh's axes:

  batch        -> (pod, data)            [activations, caches]
  embed        -> (pod, data)            [FSDP / ZeRO-3 on the d_model dim]
  vocab/mlp/experts/d_inner/ssm_heads -> model   [tensor/expert parallel]
  seq_kv       -> step-kind dependent (see below); long-context decode
                  (batch=1) shards the KV/sequence over (pod, data)   [SP]

Attention's tensor-parallel mode is chosen per step kind so that no mode
all-reduces an (S x S) score matrix:

  "heads"    : num_heads % tp == 0 and num_kv_heads % tp == 0: q and kv
               heads shard over ``model``; attention runs on each rank's
               heads with no collective.
  "expand"   : train/prefill fallback. q heads shard over ``model``
               (padded up to a multiple of tp where needed: llama4 40 -> 48,
               musicgen 24 -> 32; the padded wq columns and wo rows are
               zero-initialised and their gradients masked, so the function
               is unchanged); the kv projections are replicated and
               expanded to one kv head per q head inside attention, so each
               rank holds its q heads' kv. Prefill caches shard seq over
               ``model``.
  "head_dim" : decode fallback (q length 1): the head dim of wq/wk/wv/wo
               and of the KV cache shards; no head padding.

A mapping whose dimension does not divide the mesh axes' product falls back
to replication and is recorded in ``ShardingPolicy.fallbacks``.

The rules need only the mesh's axis names and sizes: ``mesh`` is any object
with ``axis_names`` and a ``shape`` mapping each name to its size (an
``AbstractMesh`` from ``repro_torch.launch.mesh``), or a
``torch.distributed.device_mesh.DeviceMesh`` with named dims. ``spec``
returns a plain tuple with a JAX ``PartitionSpec``'s entries (a mesh axis
name, a tuple of them, or None; trailing Nones dropped). On a DeviceMesh,
``placements`` turns a spec into DTensor placements, ``constraint``
redistributes a DTensor to them (JAX's ``with_sharding_constraint``) and
``distribute_tree`` places a tree of full tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig


def mesh_axes(mesh) -> dict:
    """{axis name: size} of an abstract mesh or a named DeviceMesh."""
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError(f"{mesh!r} has no axis names")
    return dict(zip(names, mesh.shape))


def mesh_axis_names(mesh) -> tuple:
    return tuple(mesh_axes(mesh))


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """Mesh-axis roles. Axes absent from the mesh must be omitted."""
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    pp_axis: Optional[str] = None     # optional pipeline axis

    @staticmethod
    def for_mesh(mesh, pipeline: bool = False) -> "Parallelism":
        names = mesh_axis_names(mesh)
        dp = tuple(n for n in ("pod", "data") if n in names)
        tp = "model" if "model" in names else None
        if pipeline and "pod" in names:
            dp = tuple(n for n in ("data",) if n in names)
            return Parallelism(batch_axes=dp, fsdp_axes=dp, tp_axis=tp,
                               pp_axis="pod")
        return Parallelism(batch_axes=dp, fsdp_axes=dp, tp_axis=tp)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def attn_mode(cfg: ModelConfig, tp: int, kind: str = "train") -> str:
    if cfg.num_heads == 0:
        return "none"
    if cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0:
        return "heads"
    if kind == "decode" and cfg.head_dim % tp == 0:
        return "head_dim"
    return "expand"


def padded_heads(cfg: ModelConfig, tp: int, mode: str) -> int:
    if mode != "expand":
        return cfg.num_heads
    return ((cfg.num_heads + tp - 1) // tp) * tp


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_axes(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a tree (dicts, lists, tuples) and its axes
    tree of the same structure, whose leaves are axes tuples."""
    if is_axes_leaf(axes_tree):
        return fn(tree, axes_tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, tree[k], axes_tree[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_axes(fn, t, a) for t, a in zip(tree, axes_tree))
    raise TypeError(f"no axes for leaf {type(tree)}")


@dataclasses.dataclass
class ShardingPolicy:
    """Resolves logical axis tuples to specs for (cfg, mesh, step kind)."""
    cfg: ModelConfig
    mesh: object
    parallel: Parallelism
    kind: str = "train"            # "train" | "prefill" | "decode"
    shard_seq_kv: bool = False     # long-context decode: shard cache seq dim
    fallbacks: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.axis_sizes = mesh_axes(self.mesh)
        tp = axis_size(self.mesh, self.parallel.tp_axis)
        self.tp = tp
        self.mode = attn_mode(self.cfg, tp, self.kind)
        self.h_pad = padded_heads(self.cfg, tp, self.mode)
        self._rules = self._build_rules()

    def _build_rules(self):
        par = self.parallel
        tp = par.tp_axis
        mode = self.mode
        q_heads = tp if mode in ("heads", "expand") else None
        kv_heads = tp if mode == "heads" else None
        head_dim = tp if mode == "head_dim" else None
        if self.shard_seq_kv:
            seq_kv = par.batch_axes               # long-context SP
        elif mode == "expand":
            seq_kv = tp                           # prefill cache seq over model
        else:
            seq_kv = None                         # head_dim: cache head_dim
        return {
            "batch": par.batch_axes,
            "embed": par.fsdp_axes,
            "vocab": tp,
            "q_heads": q_heads,
            "kv_heads": kv_heads,
            "head_dim": head_dim,
            "mlp": tp,
            "experts": tp,
            "expert_mlp": None,
            "d_inner": tp,
            "ssm_heads": tp,
            "head_dim_ssm": None,
            "ssm_state": None,
            "conv": None,
            "layers": None,
            "super": None,
            "norm": None,
            "seq": None,
            "act": None,
            "seq_kv": seq_kv,
        }

    def spec(self, shape, axes) -> tuple:
        """The spec of an array of ``shape`` with logical ``axes``: one entry
        a dim (a mesh axis name, a tuple of them, or None), trailing Nones
        dropped, as JAX's ``PartitionSpec``. A dim that does not divide its
        mesh axes' product is replicated and recorded in ``fallbacks``."""
        assert len(shape) == len(axes), (shape, axes)
        out = []
        for dim, name in zip(shape, axes):
            mesh_axes_ = self._rules.get(name)
            if mesh_axes_ is None:
                out.append(None)
                continue
            n = axis_size(self.mesh, mesh_axes_)
            if dim % n != 0:
                self.fallbacks.append((name, dim, mesh_axes_))
                out.append(None)
            else:
                # canonical entry: a bare name, not a 1-tuple
                if isinstance(mesh_axes_, tuple) and len(mesh_axes_) == 1:
                    mesh_axes_ = mesh_axes_[0]
                out.append(mesh_axes_)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def tree_specs(self, params, axes_tree):
        return map_axes(lambda p, a: self.spec(p.shape, a), params, axes_tree)

    # -- DTensor placements (a DeviceMesh) ---------------------------------
    def placements(self, spec) -> tuple:
        """The spec's DTensor placements, one a mesh dim in the mesh's
        order: ``Shard(d)`` on each mesh axis that dim d's entry names,
        ``Replicate()`` on every other, and on a mesh axis of one rank
        (where a shard is the whole tensor: DTensor's views do not take a
        shard of a dim of size 1). A dim over several mesh axes is split
        over them in the mesh's order (its major axis first), which is
        JAX's for an entry that names them in that order."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.axis_sizes)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            entry = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = [names.index(a) for a in entry]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's "
                                 f"axis order {tuple(names)}")
            for i in idx:
                if self.axis_sizes[names[i]] > 1:
                    out[i] = Shard(dim)
        return tuple(out)

    def placements_for(self, shape, axes) -> tuple:
        return self.placements(self.spec(shape, axes))

    def constraint(self, x, axes):
        """``x`` (a DTensor on this policy's mesh) redistributed to the
        spec of its logical ``axes``: JAX's ``with_sharding_constraint``.
        A plain tensor is returned as it is (no policy in force)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        target = self.placements_for(x.shape, axes)
        if tuple(x.placements) == target:
            return x
        return x.redistribute(self.mesh, target)

    def constrain_tree(self, tree, axes_tree):
        return map_axes(self.constraint, tree, axes_tree)

    def distribute(self, x, axes):
        """A full tensor, the same on every rank, as a DTensor in the spec of
        its logical ``axes``: each rank keeps its own slices (contiguous;
        no communication). A DTensor is returned as it is."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x
        return distribute_full(x, self.mesh, self.placements_for(x.shape,
                                                                  axes))

    def distribute_tree(self, tree, axes_tree):
        return map_axes(self.distribute, tree, axes_tree)


def local_span(shape, mesh, placements, dim: int) -> tuple:
    """(offset, size) of this rank's part of dim ``dim`` of a tensor of
    global ``shape`` in ``placements`` on ``mesh``: each mesh dim that
    shards ``dim`` splits the part the mesh dims before it left, evenly,
    as ``distribute_full`` and DTensor cut it."""
    off, size = 0, shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            size //= mesh.size(i)
            off += coord[i] * size
    return off, size


def zeros(shape, dtype, device, mesh, placements):
    """A DTensor of zeros of global ``shape`` in ``placements`` (even
    shards, as a policy's specs give): each rank allocates its own part
    only."""
    import torch
    from torch.distributed.tensor import DTensor
    local = tuple(local_span(shape, mesh, placements, d)[1]
                  for d in range(len(shape)))
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, placements)


def distribute_full(x, mesh, placements):
    """DTensor of the full tensor ``x`` (the same on every rank) with
    ``placements`` on ``mesh``: this rank's chunks, made contiguous, with
    no communication (``distribute_tensor`` would scatter from one rank,
    which gloo does not do for CUDA tensors)."""
    from torch.distributed.tensor import DTensor
    local = x
    coord = mesh.get_coordinate()
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(mesh_dim)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"divide over {n} ranks")
            local = local.chunk(n, dim=p.dim)[coord[mesh_dim]]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              shape=x.shape, stride=x.stride())
