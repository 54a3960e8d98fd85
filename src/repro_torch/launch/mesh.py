"""Device meshes for the port, from the JAX package's ``repro.launch.mesh``.

Functions, not module-level constants: importing this module starts no
process group and touches no device. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with JAX's axis names, built
over the ranks of the process group the caller started
(``torch.distributed.init_process_group``; one rank a device):

  single-pod : (data=16, model=16)          = 256 ranks
  multi-pod  : (pod=2, data=16, model=16)   = 512 ranks

The device type is ``cuda`` unless the caller asks for ``cpu``.
``AbstractMesh`` stands for a mesh by its axis names and sizes alone, with
no process group: ``ShardingPolicy`` needs nothing more, so a policy for
the production meshes is built and tested anywhere (JAX's
``jax.sharding.AbstractMesh``).

``make_fake_mesh`` builds a mesh of any size in one process over
``torch.distributed``'s fake process group (every collective returns at
once and moves nothing): the dry-run traces each production mesh's
per-rank program on meta tensors with it (``launch.dryrun``).

The roofline constants are the H100's (SXM5, 80 GB HBM3) data-sheet rates,
one card; ``chip_smoke.py`` takes its bounds from them, and the dry-run its
roofline. ``H100_NVLINK_BYTES_PER_S`` is one card's NVLink 4 rate in one
direction, which the collective term divides the ring model's wire bytes
by: NVLink joins the eight cards of a node, so on a mesh axis that crosses
nodes (over the network between them) collectives run slower, and the term
is a lower bound there.
"""
from __future__ import annotations

import math

# H100 SXM5 data sheet, one card, dense (no sparsity)
H100_BF16_FLOPS = 989e12      # bf16 tensor-core peak
H100_TF32_FLOPS = 495e12      # TF32 tensor-core peak
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3
H100_HBM_BYTES = 80e9         # HBM3 capacity
H100_NVLINK_BYTES_PER_S = 450e9   # NVLink 4, one direction (900 GB/s both)


class AbstractMesh:
    """A mesh by its axis names and sizes alone (no ranks, no devices):
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _device_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {tuple(shape)}, have {have}; start "
            f"that many processes with torch.distributed.init_process_group "
            f"(repro_torch.distributed.spawn.run_ranks) before building it")
    if have > n:
        raise RuntimeError(f"mesh {tuple(shape)} takes {n} ranks, the "
                           f"process group has {have}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh over every rank of the process group."""
    return _device_mesh(shape, axes, device_type)


def make_fake_mesh(shape, axes, device_type: str = "cpu"):
    """A DeviceMesh of ``prod(shape)`` ranks with axis names ``axes`` in this
    one process, over ``torch.distributed``'s fake process group (this
    process is rank 0; a collective returns at once and moves nothing).
    Raises if a process group is already started: the fake group is this
    process's only one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            f"a process group ({dist.get_backend()}, world size "
            f"{dist.get_world_size()}) is already started; a fake mesh "
            f"needs a process of its own")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
