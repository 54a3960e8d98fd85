"""Run a function on N ranks of a fresh ``torch.distributed`` process group.

    results = run_ranks(fn, 4, backend="gloo", device_type="cpu", args=(...))

Each rank is a process started with the ``spawn`` method (no fork of a
process that may hold threads or a CUDA context): it joins a process group
whose rendezvous is a ``FileStore`` in a new temporary directory (no port
is taken, so parallel callers never collide), calls ``fn(rank, world, *args)``
and sends back its return value, which must pickle. ``fn`` must be
importable by its module name. On ``cuda`` every rank uses card ``rank %
device_count()``, so N ranks may share one card (NCCL refuses two ranks on
one card, so such a group runs gloo, whose CUDA collectives go through the
host: ``comm.install_host_staging``). A rank that raises fails the call with
that rank's traceback; a call that outlasts ``timeout`` seconds kills every
rank and raises ``TimeoutError``. No rank outlives the call.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, backend, device_type, store_path, threads,
               args, out):
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        if backend == "gloo" and device_type == "cuda":
            from repro_torch.distributed import comm
            comm.install_host_staging()
        try:
            result = fn(rank, world, *args)
        except BaseException:
            # the rank's own failure, told apart from its peers' broken
            # connections that follow it
            out.put((rank, False, traceback.format_exc()))
            return
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))


def run_ranks(fn, world: int, *, backend: str = "gloo",
              device_type: str = "cpu", args: tuple = (),
              timeout: float = 600.0, threads: int = 1) -> list:
    """``fn(rank, world, *args)`` on ``world`` ranks; their results in rank
    order. ``threads`` caps each rank's intra-op threads on the CPU (0: the
    default)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type cuda asks for a card; there is none")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend, device_type, store,
                                   threads, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors, lost = {}, {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) + len(errors) + len(lost) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__name__} on {world} ranks: ranks "
                        f"{sorted(set(range(world)) - set(results) - set(lost))}"
                        f" gave nothing in {timeout:.0f} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results and r not in lost]
                    if dead:
                        raise RuntimeError(
                            f"{fn.__name__}: rank(s) {dead} died with exit "
                            f"code(s) {[procs[r].exitcode for r in dead]}")
                    continue
                if ok:
                    results[rank] = value
                elif ok is None:
                    lost[rank] = value
                else:
                    errors[rank] = value
                    # one rank's failure leaves the others waiting on it
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if not (errors or lost) else 0.5)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = errors or lost
    if errors:
        rank = min(errors)
        raise RuntimeError(f"{fn.__name__} failed on rank {rank} of {world}:"
                           f"\n{errors[rank]}")
    return [results[r] for r in range(world)]
