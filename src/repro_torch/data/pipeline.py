"""Host-sharded synthetic token pipeline with packing and prefetch.

The paper's VREs feed containerized tools from a shared data space; the
TPU-native analogue is a deterministic, host-partitioned token stream: every
host derives its shard purely from (seed, host_id, num_hosts, step) — the
same decentralized self-configuration idea as cloud-init contextualization
(no coordinator hands out work).

A port of the JAX package's ``repro.data.pipeline``: batches are made with
numpy, so they equal the JAX package's bit for bit for the same seed and
host shard; ``device_batch`` moves one to a torch device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512       # documents are packed into fixed windows
    embeddings_dim: int = 0       # >0: emit embedding inputs (stub frontends)
    dtype: str = "int32"


class SyntheticLMData:
    """Deterministic packed-LM batches, partitioned by host."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.cfg.seed, counter=[step, self.host_id, 0, 0]))

    def batch(self, step: int) -> dict:
        """Pack synthetic 'documents' (geometric lengths) into the window."""
        c = self.cfg
        rng = self._rng(step)
        toks = np.empty((self.local_batch, c.seq_len + 1), np.int32)
        for row in range(self.local_batch):
            filled = 0
            while filled < c.seq_len + 1:
                doc_len = min(1 + rng.geometric(1.0 / c.mean_doc_len),
                              c.seq_len + 1 - filled)
                toks[row, filled:filled + doc_len] = rng.integers(
                    1, c.vocab_size, size=doc_len)
                filled += doc_len
        inputs, labels = toks[:, :-1], toks[:, 1:]
        if c.embeddings_dim:
            emb = rng.standard_normal(
                (self.local_batch, c.seq_len, c.embeddings_dim),
                dtype=np.float32) * 0.02
            return {"inputs": emb, "labels": np.ascontiguousarray(labels)}
        return {"inputs": np.ascontiguousarray(inputs),
                "labels": np.ascontiguousarray(labels)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def device_batch(batch: dict, device) -> dict:
    """Place a host batch onto ``device`` as tensors (no copy of the host
    arrays where ``device`` is the CPU)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def split_partitions(data: np.ndarray, n: int) -> list:
    """The paper's tool-parallelization primitive: split a dataset into N
    roughly-equal partitions (Fig. 5/6 use this split)."""
    return np.array_split(data, n)
