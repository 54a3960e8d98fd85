"""Per-device counts of one step of the port: FLOPs, memory bytes,
collectives, kernel calls and peak memory, counted while the step runs.

The counterpart of the JAX package's ``launch/hlo_analysis.py``. That file
parses the compiled HLO of a step. The port compiles nothing and has no
HLO: its step is the sequence of torch ops that eager PyTorch dispatches,
plus the hand-written kernels. So ``analyze_step(fn, *args)`` runs ``fn``
under a ``TorchDispatchMode`` and counts what one rank dispatches. On meta
tensors over a fake process group (``launch.mesh.make_fake_mesh``), rank 0
stands for every rank, as JAX's SPMD module is the per-device program; on
the card it counts the real run, and the two counts agree
(``chip_smoke.py``'s ``dryrun`` phase). Per step:

  * dot FLOPs     : the GEMM ops (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
                    by ``torch.utils.flop_counter``'s formulas; ``einsum``
                    and ``matmul`` reach the dispatcher as these
  * convolution   : ``convolution`` and its backward, by the same formulas
  * kernel FLOPs  : each hand-written kernel call at its analytic count
                    (``kernels.costs``), reported by the kernel op itself,
                    by kernel and direction, with its bytes and calls
  * memory bytes  : each non-view op's tensor inputs plus outputs on the
                    step's device (eager PyTorch writes every op's output
                    to memory, so the op is the materialisation boundary,
                    where XLA's is the fusion), plus the kernels' bytes
  * collectives   : DTensor's (``_c10d_functional``, ``_dtensor``) and the
                    port's explicit ones (``distributed/comm.py`` on
                    ``c10d``), each counted once by kind with JAX's
                    ring-model wire bytes from its output bytes and the
                    size of its group:
                        all-gather          out * (g-1)/g
                        all-reduce          2 * out * (g-1)/g
                        reduce-scatter      out * (g-1)
                        all-to-all          out * (g-1)/g
                        collective-permute  out       (send; the recv is
                                                       its other end)
                        broadcast           out
  * peak memory   : a live-storage tracker over the same run: the bytes of
                    every storage on the step's device, from the step's
                    arguments and every op's new outputs until each is
                    freed, rounded up to the caching allocator's 512-byte
                    blocks; argument, output and temporary bytes, and their
                    peak
  * compute_s     : each op's FLOPs over the card's peak for its type (bf16
                    on the tensor cores; f32 on the CUDA cores, as torch's
                    default matmul precision leaves TF32 off), the kernels'
                    at their own instruction class

Only the rank's local work counts. An op on DTensors is skipped
(``NotImplemented``): DTensor's dispatch then runs it as local ops, which
are counted. An op on ``FakeTensor``s is run and not counted: that is
DTensor's sharding propagation, which runs each op once at the global
shapes and caches the result, so counting it would make the count depend
on the cache.

A Shard(i) -> Shard(j) redistribution on a mesh of device type ``cpu``
runs in DTensor as an all-gather and a chunk (gloo has no all-to-all). On
meta tensors the analysis issues it as the one ``_dtensor`` all-to-all
that a CUDA mesh issues, and counts that.

Loops: ``trips(n)`` is ``range(n)`` for a loop of n like iterations (the
train step's microbatches). Under an analysis made with ``weight_loops``
it runs the body twice, the first iteration counted once (it also does the
one-time work, such as a cache's first fill) and the second weighted by
n - 1: the port's counterpart of XLA's known trip counts. The values are
then those of two iterations, so it is for meta tensors.

Not counted, unlike JAX's analysis: no ``hbm_bytes_tpu`` or ``upcast_*``
(those correct XLA-CPU's bf16 upcasts, which eager PyTorch does not make)
and no ``num_loops`` or ``trip_counts`` (there are no while loops to
find).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs
from repro_torch.launch.mesh import H100_BF16_FLOPS, H100_F32_FLOPS

BLOCK = 512     # the CUDA caching allocator's rounding of every allocation

_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "broadcast",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "broadcast_"): "broadcast",
}

# ops that neither read nor write memory: allocations whose contents are
# unset, aliases, and the functional collectives' waits and wrappers
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "wait_tensor", "_wrap_tensor_autograd", "recv_"}


def _wire_bytes(kind: str, out: float, g: int) -> float:
    if kind == "all-gather" or kind == "all-to-all":
        return out * (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2 * out * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return out * (g - 1)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _blocks(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _peak_flops(dtype) -> float:
    return H100_BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) \
        else H100_F32_FLOPS


@dataclasses.dataclass
class ModuleStats:
    """One step's per-device counts (JAX's field names where the quantity is
    the same)."""
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_per_op: dict = dataclasses.field(default_factory=dict)
    coll_raw_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    # by kernel, then direction ("fwd", "bwd"; the grouped matmul's "dx",
    # "dw")
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    kernel_bytes: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    compute_s: float = 0.0
    memory: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self):
        """GEMMs, convolutions and the kernels' analytic FLOPs."""
        return self.dot_flops + self.conv_flops + sum(
            v for d in self.kernel_flops.values() for v in d.values())

    def to_json(self):
        return {
            "dot_flops": self.dot_flops, "conv_flops": self.conv_flops,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collectives": {"per_op": self.coll_per_op,
                            "raw_bytes": self.coll_raw_bytes,
                            "wire_bytes": self.coll_wire_bytes},
            "kernels": {"flops": self.kernel_flops,
                        "bytes": self.kernel_bytes,
                        "calls": self.kernel_calls},
            "compute_s": self.compute_s,
            "memory": self.memory,
        }


_ACTIVE: list = []


def trips(n: int):
    """``range(n)`` for a loop of ``n`` like iterations; under an analysis
    made with ``weight_loops``, two: the first counted once (it also does
    the work that later iterations find done, such as filling a cache) and
    the second weighted by ``n - 1``."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is None or not counter.weight_loops or n <= 2:
        yield from range(n)
        return
    yield 0
    counter.weight *= n - 1
    try:
        yield 1
    finally:
        counter.weight //= n - 1


class _Counter(TorchDispatchMode):
    def __init__(self, device_type: str, weight_loops: bool):
        super().__init__()
        self.device_type = device_type
        self.weight_loops = weight_loops
        self.weight = 1
        self.stats = ModuleStats()
        self._coll = defaultdict(lambda: {"count": 0.0, "raw_bytes": 0.0,
                                          "wire_bytes": 0.0})
        self._live = {}         # id(storage) -> bytes
        self._refs = {}         # id(storage) -> weakref.finalize
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- memory --------------------------------------------------------
    def track(self, t):
        if not isinstance(t, torch.Tensor) or \
                t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = _blocks(st.nbytes())
        self._live[key] = n
        self._refs[key] = weakref.finalize(st, self._free, key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)

    def storage_bytes(self, tensors) -> int:
        seen = {}
        for t in tensors:
            if isinstance(t, torch.Tensor) and \
                    t.device.type == self.device_type:
                st = t.untyped_storage()
                seen[id(st)] = _blocks(st.nbytes())
        return sum(seen.values())

    def close(self):
        for ref in list(self._refs.values()):
            ref.detach()
        self._refs.clear()

    # -- kernels -------------------------------------------------------
    def kernel(self, kernel, direction, shapes, cost):
        w, s = self.weight, self.stats
        for table, v in ((s.kernel_flops, cost.flops),
                         (s.kernel_bytes, cost.bytes),
                         (s.kernel_calls, 1)):
            d = table.setdefault(kernel, {})
            d[direction] = d.get(direction, 0) + w * v
        s.hbm_bytes += w * cost.bytes
        s.compute_s += w * cost.ops_s

    # -- ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        leaves = tree_leaves((args, kwargs))
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in leaves + outs):
            return out
        for t in outs:
            self.track(t)
        self._count(func, args, kwargs, leaves, out, outs)
        return out

    def _count(self, func, args, kwargs, leaves, out, outs):
        w, s = self.weight, self.stats
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        dev = self.device_type
        kind = _COLLECTIVES.get((ns, name))
        if kind is not None:
            self._collective(kind, ns, args, kwargs, outs)
        packet = func._overloadpacket
        if packet in flop_registry and outs and outs[0].device.type == dev:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            conv = "convolution" in name
            if conv:
                s.conv_flops += w * flops
            else:
                s.dot_flops += w * flops
            s.compute_s += w * flops / _peak_flops(outs[0].dtype)
        if func.is_view or name in _NO_BYTES:
            return
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        n = sum(_nbytes(t) for t in ins + outs if t.device.type == dev)
        s.hbm_bytes += w * n

    def _collective(self, kind, ns, args, kwargs, outs):
        leaves = tree_leaves((args, kwargs))
        if ns == "c10d":
            # the group is an argument; the ops work in place, their first
            # argument the outputs (a gather's parts; a send's tensor)
            g = next(torch.distributed.ProcessGroup.unbox(a).size()
                     for a in leaves if isinstance(a, torch.ScriptObject)
                     and "ProcessGroup" in str(a._type()))
            tensors = [t for t in tree_leaves(args[0])
                       if isinstance(t, torch.Tensor)]
        else:
            # the group by its name, the last string argument
            name = [a for a in leaves if isinstance(a, str)][-1]
            g = _resolve_process_group(name).size()
            tensors = outs[:1]
        raw = sum(_nbytes(t) for t in tensors)
        d = self._coll[kind]
        d["count"] += self.weight
        d["raw_bytes"] += self.weight * raw
        d["wire_bytes"] += self.weight * _wire_bytes(kind, raw, g)

    def finish(self):
        s = self.stats
        s.coll_per_op = {k: dict(v) for k, v in self._coll.items()}
        s.coll_raw_bytes = sum(d["raw_bytes"] for d in s.coll_per_op.values())
        s.coll_wire_bytes = sum(d["wire_bytes"]
                                for d in s.coll_per_op.values())


@contextlib.contextmanager
def _cuda_mesh_alltoall():
    """DTensor's Shard(i) -> Shard(j) on meta tensors as the one all-to-all
    a CUDA mesh issues, where a ``cpu`` mesh would all-gather and chunk."""
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor import placement_types as pt
    orig = cu.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        name = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                     shard_dim, name)
    patched = [m for m in (cu, pt)
               if getattr(m, "shard_dim_alltoall", None) is orig]
    for m in patched:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in patched:
            m.shard_dim_alltoall = orig


def _local_leaves(tree):
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def step_device(args) -> str:
    """The device type a step's counts are kept on: that of its first
    argument tensor off the host (a DTensor's local tensor), else ``cpu``."""
    for t in _local_leaves(args):
        if t.device.type != "cpu":
            return t.device.type
    return "cpu"


def analyze_step(fn, *args, weight_loops: bool = False,
                 device_type: str | None = None):
    """Run ``fn(*args)`` once under the counter: (its result, its
    ``ModuleStats``). ``device_type`` (default ``step_device(args)``) is
    the device whose memory and bytes are counted; host tensors (the decode
    positions a step reads on the host) are not. ``weight_loops`` makes
    ``trips`` loops run once, weighted by their count."""
    dev = device_type or step_device(args)
    counter = _Counter(dev, weight_loops)
    arg_locals = _local_leaves(args)
    for t in arg_locals:
        counter.track(t)
    arg_bytes = counter.live_bytes
    _ACTIVE.append(counter)
    try:
        with _cuda_mesh_alltoall(), costs.reports_to(counter.kernel), \
                counter:
            out = fn(*args)
    finally:
        _ACTIVE.remove(counter)
    counter.finish()
    out_locals = _local_leaves(out)
    ids = {id(t.untyped_storage()) for t in arg_locals}
    counter.stats.memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": counter.storage_bytes(
            [t for t in out_locals if id(t.untyped_storage()) not in ids]),
        "temp_bytes": counter.peak_bytes - arg_bytes,
        "peak_bytes": counter.peak_bytes,
    }
    counter.close()
    return out, counter.stats

