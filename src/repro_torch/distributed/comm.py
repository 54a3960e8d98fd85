"""Collectives on local tensors over a mesh axis's process group, for the
code that the JAX package writes inside ``shard_map`` (the MoE's
expert-parallel body, the loss over a vocab-sharded logits tensor, the
compressed reduction, the pipeline).

The differentiable ones say what their backward is, since on local tensors
autograd cannot know whether a value is the same on every rank:

  ``sum_over``       all-reduce SUM; backward passes the gradient as it is
                     (each rank's summand gets the sum's gradient)
  ``mean_over``      all-reduce SUM / n; backward the gradient / n
  ``enter``          identity; backward all-reduce SUM (a value used by
                     every rank, each adding its own part of its gradient)
  ``gather``         all-gather along a dim; backward reduce-scatter SUM
                     (each rank's copy of the whole is used differently)
  ``gather_same``    all-gather along a dim; backward this rank's slice of
                     the gradient (the gradient is the same on every rank)

A group of one rank makes each of them the identity.

**Gloo and CUDA tensors.** NCCL takes one rank a card, so ranks that share
one card run gloo, which works on host memory. The card's torch build gives
gloo no CUDA tensor at all: its all-reduce of one stops the process
(``gloo::IoException ... writev: Bad address``, found on the card). So on a
gloo group every collective of a CUDA tensor goes through pinned host
memory, explicitly: these helpers copy the tensor to the host, run the
collective there and copy the result back; ``install_host_staging`` does
the same for the functional collectives that DTensor issues (it overrides
their CUDA kernels; ``spawn.run_ranks`` installs it for a gloo group on
CUDA, nowhere else). ``staged`` counts the staged calls by op (DTensor's
as ``dtensor_<op>``) and ``host_staged`` their bytes. Nothing else moves
compute off the card.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

# staged calls by op, and the bytes they moved to the host (a run resets
# them to show what was staged)
staged = Counter()
host_staged = Counter()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staging(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through the host:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """All-reduce ``t`` in place over ``group``; returns ``t``."""
    if group_size(group) == 1:
        return t
    if _staging(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        staged["all_reduce"] += 1
        host_staged["all_reduce"] += t.numel() * t.element_size()
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, dim: int = 0):
    """The group's tensors concatenated along ``dim`` in rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    stage = _staging(t, group)
    src = _to_host(t) if stage else t
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    if stage:
        staged["all_gather"] += 1
        host_staged["all_gather"] += out.numel() * out.element_size()
        out = out.to(t.device)
    return out


def reduce_scatter(t, group, dim: int = 0):
    """Sum of the group's ``t`` over the ranks, this rank's slice along
    ``dim`` (equal slices in rank order)."""
    n = group_size(group)
    if n == 1:
        return t
    parts = [c.contiguous() for c in t.chunk(n, dim=dim)]
    if _staging(t, group):
        # the sum of every slice on the host, then this rank's
        h = _to_host(torch.cat([p.reshape(-1) for p in parts]))
        dist.all_reduce(h, group=group)
        staged["reduce_scatter"] += 1
        host_staged["reduce_scatter"] += h.numel() * h.element_size()
        k = dist.get_rank(group)
        size = parts[k].numel()
        return h[k * size:(k + 1) * size].view(parts[k].shape).to(t.device)
    out = torch.empty(parts[0].numel(), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, torch.cat([p.reshape(-1) for p in parts]),
                               group=group)
    return out.view(parts[0].shape)


def send_recv(t, dst: int, src: int, group):
    """Send ``t`` to group rank ``dst`` while taking a tensor like it from
    group rank ``src``; returns the received tensor."""
    t = t.contiguous()
    stage = _staging(t, group)
    out = torch.empty_like(_to_host(t) if stage else t)
    payload = _to_host(t) if stage else t
    g_dst = dist.get_global_rank(group, dst)
    g_src = dist.get_global_rank(group, src)
    if t.device.type == "meta":
        # the dry-run's fake group has no backend for a meta batch: the
        # same pair as two calls
        works = [dist.isend(payload, g_dst, group),
                 dist.irecv(out, g_src, group)]
    else:
        works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, payload, g_dst, group),
             dist.P2POp(dist.irecv, out, g_src, group)])
    for w in works:
        w.wait()
    if stage:
        staged["send"] += 1
        staged["recv"] += 1
        host_staged["send"] += t.numel() * t.element_size()
        out = out.to(t.device)
    return out


def broadcast(t, src: int, group):
    """``t`` from group rank ``src`` on every rank, in place."""
    if group_size(group) == 1:
        return t
    src = dist.get_global_rank(group, src)
    if _staging(t, group):
        h = _to_host(t)
        dist.broadcast(h, src, group=group)
        staged["broadcast"] += 1
        host_staged["broadcast"] += h.numel() * h.element_size()
        return t.copy_(h)
    dist.broadcast(t, src, group=group)
    return t


# -- differentiable ---------------------------------------------------------

class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group_size(group)
        return all_reduce(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.summed = group, dim, summed
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        n = group_size(ctx.group)
        part = g.chunk(n, dim=ctx.dim)[group_rank(ctx.group)]
        return part.contiguous(), None, None, None


def _one(group) -> bool:
    return group_size(group) == 1


def sum_over(x, group):
    return x if _one(group) else _SumOver.apply(x, group)


def mean_over(x, group):
    return x if _one(group) else _MeanOver.apply(x, group)


def enter(x, group):
    return x if _one(group) else _Enter.apply(x, group)


def gather(x, group, dim: int):
    return x if _one(group) else _Gather.apply(x, group, dim, True)


def gather_same(x, group, dim: int):
    return x if _one(group) else _Gather.apply(x, group, dim, False)


# -- DTensor's collectives on a gloo group of CUDA ranks -------------------

_STAGING = []


def _staged_call(op: str, t: torch.Tensor, run):
    """``run`` (a functional collective) on a pinned host copy of ``t``,
    waited for, its result copied back to ``t``'s card."""
    f = torch.ops._c10d_functional
    host = _to_host(t)
    out = f.wait_tensor(run(host))
    staged[f"dtensor_{op}"] += 1
    host_staged[f"dtensor_{op}"] += out.numel() * out.element_size()
    return out.to(t.device)


def _shard_dim_alltoall(t, gather_dim, shard_dim, group_name):
    """DTensor's Shard(i) -> Shard(j) as its gloo fallback: all-gather along
    ``gather_dim`` on the host, keep this rank's chunk along
    ``shard_dim``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    n = dist.get_world_size(group)
    f = torch.ops._c10d_functional
    whole = _staged_call("all_gather", t.contiguous(), lambda h: f.
                         all_gather_into_tensor(h, n, group_name))
    whole = torch.cat(whole.chunk(n), dim=gather_dim)
    return whole.chunk(n, dim=shard_dim)[dist.get_rank(group)].contiguous()


def install_host_staging():
    """Give the functional collectives (``torch.ops._c10d_functional``, and
    DTensor's Shard-to-Shard all-to-all) CUDA kernels that stage through
    pinned host memory, for a process whose groups are gloo and whose
    tensors are on a card. Once a process; counted in ``staged``."""
    if _STAGING:
        return
    f = torch.ops._c10d_functional
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_reduce_(t, op, g):
        return t.copy_(_staged_call("all_reduce", t,
                                    lambda h: f.all_reduce(h, op, g)))
    kernels = {
        "all_reduce": lambda t, op, g: _staged_call(
            "all_reduce", t, lambda h: f.all_reduce(h, op, g)),
        "all_reduce_": all_reduce_,
        "all_gather_into_tensor": lambda t, n, g: _staged_call(
            "all_gather", t, lambda h: f.all_gather_into_tensor(h, n, g)),
        "reduce_scatter_tensor": lambda t, op, n, g: _staged_call(
            "reduce_scatter", t,
            lambda h: f.reduce_scatter_tensor(h, op, n, g)),
        "all_to_all_single": lambda t, out_s, in_s, g: _staged_call(
            "all_to_all", t, lambda h: f.all_to_all_single(h, out_s, in_s,
                                                           g)),
        "broadcast": lambda t, src, g: _staged_call(
            "broadcast", t, lambda h: f.broadcast(h, src, g)),
    }
    for name, fn in kernels.items():
        lib.impl(name, fn, "CUDA")
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", _shard_dim_alltoall, "CUDA")
    _STAGING.extend([lib, dlib])


def local_whole(w, parallel):
    """DTensor ``w``'s local tensor all-gathered over every mesh axis but
    the tp axis, along the dim that axis shards (the minor axis first: a
    dim split over (pod, data) is gathered over data, then pod). Its
    gradient is summed over each such axis (each rank uses the whole with
    its own tokens), and over each batch axis ``w`` is replicated on."""
    from torch.distributed.tensor import Partial
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    local = w.to_local(grad_placements=[
        Partial() if n in parallel.batch_axes and not p.is_shard() else p
        for n, p in zip(names, w.placements)])
    for i in reversed(range(mesh.ndim)):
        p = w.placements[i]
        if p.is_shard() and names[i] != parallel.tp_axis:
            local = gather(local, axis_group(mesh, names[i]), p.dim)
    return local


def axis_group(mesh, axes):
    """The process group of ``mesh``'s axis, or of the axes of a tuple
    (only where one of them has more than one rank: a group spanning
    several mesh axes is not kept here); None for no axis."""
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = list(mesh.mesh_dim_names)
    real = [a for a in axes if mesh.size(names.index(a)) > 1]
    if not real:
        return None
    if len(real) > 1:
        raise ValueError(f"axes {real} span more than one mesh axis of "
                         f"more than one rank: take them one at a time")
    return mesh.get_group(real[0])
