"""Sharded, async, atomically-committed checkpoint store. The
GlusterFS-storage-node analogue from the paper:

  * a configurable number of *storage servers* (``num_servers``) serialize
    writes — scarce storage nodes reproduce the paper's I/O-contention
    leveling (Fig. 5, Azure 1-storage-node case);
  * writes are asynchronous (background thread) with a versioned manifest
    and an atomic COMMIT marker — the trainer never blocks on I/O;
  * ``restore`` puts each leaf on the device of the matching leaf of
    ``like``, or, given ``placements``, distributes it onto a mesh (which
    may differ from the one it was saved from: an elastic restart).

A DTensor leaf (a sharded train state) is saved as its full value: every
rank of its mesh gathers it (a collective, so every rank calls ``save``)
and global rank 0 alone writes the step.

A port of the JAX package's ``repro.checkpoint.store`` to nested dicts and
lists of torch tensors, in the same on-disk format, so either package
restores the other's step: one ``.npy`` per leaf, keyed ``"a/b/0"`` with
dict keys in sorted order (the order ``jax.tree_util`` flattens them in);
bfloat16 and float8 leaves stored as unsigned integers of their width with
the dtype in ``manifest.json``; a ``COMMITTED`` marker once the step is
whole.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import distribute_full

# numpy can't natively serialize bf16/f8 — bit-cast through a same-width
# unsigned int and restore via the manifest's dtype record
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return np.asarray(v).dtype.name


def _to_savable(v) -> np.ndarray:
    """A leaf as the numpy array written to disk (exotic floats as their
    bits in an unsigned integer of the same width); a DTensor's full
    value."""
    name = _dtype_name(v)
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        # a copy even on the CPU: the train step updates its state in
        # place while an asynchronous save is still writing it
        t = v.detach().to("cpu", copy=True)
        if name in _EXOTIC:
            return t.view(_EXOTIC[name][2]).numpy().view(_EXOTIC[name][1])
        return t.numpy()
    arr = np.asarray(v)
    return arr.view(_EXOTIC[name][1]) if name in _EXOTIC else arr


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        dtype, _, same_width = _EXOTIC[dtype_name]
        signed = arr.view(np.int16) if same_width == torch.int16 else arr
        return torch.from_numpy(signed).view(dtype)
    return torch.from_numpy(arr)


def _flatten_with_paths(tree, prefix: tuple = (),
                        pair: bool = False) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    list and tuple items by index, None an empty subtree. With ``pair``, a
    2-tuple whose first item is not a container (a (mesh, placements)
    pair) is a leaf."""
    if pair and isinstance(tree, tuple) and len(tree) == 2 and \
            not isinstance(tree[0], (dict, list, tuple)):
        return [("/".join(prefix), tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),),
                                              pair)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (str(i),), pair)]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves: dict, prefix: tuple = ()):
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return leaves["/".join(prefix)]


class CheckpointStore:
    def __init__(self, root: str, num_servers: int = 4,
                 server_bandwidth_bytes_s: Optional[float] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.num_servers = max(1, num_servers)
        self.server_bandwidth = server_bandwidth_bytes_s
        self._server_locks = [threading.Lock() for _ in range(self.num_servers)]
        self._commit_pool = ThreadPoolExecutor(max_workers=2)
        self._pending = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _write_leaf(self, path: Path, key: str, arr: np.ndarray):
        server = hash(key) % self.num_servers
        with self._server_locks[server]:
            if self.server_bandwidth:
                time.sleep(arr.nbytes / self.server_bandwidth)
            np.save(path / (key.replace("/", "__") + ".npy"), arr)

    def save(self, state: Any, step: int, blocking: bool = False):
        """Copy to the host + async write; atomic COMMIT marker at the
        end. A state with DTensor leaves is gathered on every rank and
        written by global rank 0 alone (the others return the manifest and
        write nothing)."""
        flat = _flatten_with_paths(state)
        host_leaves = [(k, _dtype_name(v), _to_savable(v)) for k, v in flat]
        writer = not any(isinstance(v, DTensor) for _, v in flat) or \
            torch.distributed.get_rank() == 0
        d = self.step_dir(step)
        tmp = d.with_suffix(".tmp")
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": [{"key": k, "shape": list(v.shape), "dtype": name}
                       for k, name, v in host_leaves],
        }

        def _commit():
            # leaves are written inline (the per-server locks still model
            # storage contention)
            for k, _name, v in host_leaves:
                self._write_leaf(tmp, k, v)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            os.rename(tmp, d)
            (d / "COMMITTED").touch()

        if writer and blocking:
            _commit()
        elif writer:
            fut = self._commit_pool.submit(_commit)
            with self._lock:
                self._pending.append(fut)
        return manifest

    def wait(self, timeout_s: float = 300.0):
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result(timeout=timeout_s)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                 if (p / "COMMITTED").exists()]
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                placements: Any = None) -> Any:
        """Restore into the structure of ``like`` as tensors, each on the
        device of the matching leaf of ``like`` (the CPU where that leaf is
        not a tensor). ``placements``, a tree of ``like``'s structure whose
        leaves are ``(mesh, placements)`` pairs (JAX's ``shardings``), puts
        each leaf, read whole on every rank, onto its mesh's device type as
        a DTensor with those placements (each rank keeps its own slices),
        whatever mesh it was saved from."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.root}")
        d = self.step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        dtypes = {e["key"]: e["dtype"] for e in manifest["leaves"]}
        where = dict(_flatten_with_paths(placements, pair=True)) \
            if placements is not None else {}
        out = {}
        for k, leaf in _flatten_with_paths(like):
            arr = np.load(d / (k.replace("/", "__") + ".npy"))
            t = _from_saved(arr, dtypes.get(k, arr.dtype.name))
            if k in where:
                mesh, place = where[k]
                out[k] = distribute_full(t.to(mesh.device_type), mesh, place)
            else:
                out[k] = t.to(leaf.device) if isinstance(
                    leaf, torch.Tensor) else t
        return _unflatten(like, out)

    def gc(self, keep_last: int = 3):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.root.glob("step_*")
                       if (p / "COMMITTED").exists())
        for s in steps[:-keep_last]:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
