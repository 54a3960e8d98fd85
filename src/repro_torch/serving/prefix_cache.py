"""Cross-request prefix caching for chunked prefill, ported from the JAX
package's ``repro.serving.prefix_cache``.

Scientific-pipeline serving traffic is prefix-heavy: requests share a long
system/context head and differ only in a short payload (the paper's VRE
users run the *same* pipeline over different inputs). ``PrefixCache`` is a
trie keyed on token-id prefixes at chunk granularity: after an engine
prefills a chunk ending at a chunk boundary, it offers the per-layer KV
state of that chunk; a later request whose prompt starts with the same
tokens restores the deepest cached boundary and prefills only its tail.

Entries are **host CPU tensors** (numpy has no bfloat16), which makes them
device-agnostic: one cache serves replicas on different cards, and a restore
copies the entry to the restoring engine's own device. An entry's size is
``numel() * element_size()`` summed over its leaves. The engine treats a
restore failure as a miss, so a wrong-shaped entry degrades to recompute
rather than an error. An LRU byte budget bounds host memory; hit / miss /
eviction / byte gauges are published into the monitoring plane.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch


def _tree_map(fn, tree):
    """Minimal pytree map over the nested list/tuple/dict cache structures
    the models produce."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    out = []

    def rec(t):
        if isinstance(t, dict):
            for v in t.values():
                rec(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                rec(v)
        else:
            out.append(t)
    rec(tree)
    return out


def _tree_concat(trees, axis=1):
    """Concatenate same-structure host trees along the position axis
    (leaves are (n_super, L, kv_heads, head_dim))."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_concat([t[k] for t in trees], axis) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_concat([t[i] for t in trees], axis)
                        for i in range(len(t0)))
    return torch.cat(trees, dim=axis)


class _Node:
    __slots__ = ("children", "entry", "nbytes", "length")

    def __init__(self):
        self.children = {}          # chunk token-tuple -> _Node
        self.entry = None           # host KV tree of this node's chunk
        self.nbytes = 0
        self.length = 0


class PrefixCache:
    """LRU trie of per-layer KV states at chunk boundaries.

    Shared across every replica of a pool (and across pool generations via
    ``adopt_entries``), so one request's prefill warms all replicas. Thread
    safe: engine decode loops run on background threads.
    """

    def __init__(self, chunk_tokens: int, budget_bytes: int = 64 << 20,
                 monitor=None, name: str = "prefix-cache"):
        assert chunk_tokens >= 1
        self.chunk = int(chunk_tokens)
        self.budget = int(budget_bytes)
        self.monitor = monitor
        self.name = name
        self._lock = threading.Lock()
        self._root = _Node()
        self._lru: "OrderedDict[tuple, _Node]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.insertions = 0
        self.nbytes = 0
        self.hit_tokens = 0

    # -- lookup ------------------------------------------------------------
    def lookup(self, tokens) -> Tuple[int, Optional[object]]:
        """Longest cached prefix of ``tokens`` at chunk granularity.
        Returns ``(covered_len, kv_tree)`` — ``(0, None)`` on a miss. Each
        trie node stores only its own chunk's KV slice (no duplication
        across boundaries); the restore tree is assembled by concatenating
        the chain, so coverage stops at the first evicted link. The
        returned tree holds host CPU tensors."""
        toks = np.asarray(tokens)
        with self._lock:
            node = self._root
            chain, key = [], []
            for s in range(0, len(toks) - len(toks) % self.chunk, self.chunk):
                piece = tuple(int(t) for t in toks[s:s + self.chunk])
                node = node.children.get(piece)
                if node is None or node.entry is None:
                    break
                key.append(piece)
                chain.append(node.entry)
                self._lru.move_to_end(tuple(key))   # whole chain is recent
            if not chain:
                self.misses += 1
                self._publish()
                return 0, None
            covered = len(chain) * self.chunk
            self.hits += 1
            self.hit_tokens += covered
            self._publish()
        return covered, _tree_concat(chain)

    def contains(self, tokens) -> bool:
        """True iff an entry exists for exactly this prefix (its length must
        be a chunk multiple). Cheap presence probe so engines skip the
        device->host copy on already-cached boundaries."""
        toks = np.asarray(tokens)
        if len(toks) % self.chunk:
            return False
        with self._lock:
            node = self._root
            for s in range(0, len(toks), self.chunk):
                piece = tuple(int(t) for t in toks[s:s + self.chunk])
                node = node.children.get(piece)
                if node is None:
                    return False
            return node.entry is not None

    # -- insert / evict ----------------------------------------------------
    def insert(self, tokens, kv_tree) -> bool:
        """Store the KV slice for the *last chunk* of prompt prefix
        ``tokens`` (prefix length must be a chunk multiple; ``kv_tree``
        covers positions ``[len(tokens) - chunk, len(tokens))`` only — the
        per-chunk delta scheme keeps a k-chunk head at k slices instead of
        the ~k^2/2 positions that storing every full prefix would cost).
        Leaves are kept as host CPU tensors (a device tensor is copied to
        the host; a CPU tensor is kept, so pass one no one writes to).
        Returns False (and stores nothing) for malformed lengths."""
        toks = np.asarray(tokens)
        n = len(toks)
        if n == 0 or n % self.chunk:
            return False
        host = _tree_map(lambda x: torch.as_tensor(x).cpu(), kv_tree)
        nbytes = sum(leaf.numel() * leaf.element_size()
                     for leaf in _tree_leaves(host))
        with self._lock:
            node = self._root
            key = []
            for s in range(0, n, self.chunk):
                piece = tuple(int(t) for t in toks[s:s + self.chunk])
                parent = node
                node = parent.children.get(piece)
                if s + self.chunk < n:
                    # ancestor link: must itself hold an entry, else the
                    # restore chain can never reach the new entry (e.g. the
                    # ancestor was evicted between this prompt's chunk
                    # inserts) and storing it would only hold budget bytes
                    # hostage
                    if node is None or node.entry is None:
                        return False
                else:
                    node = parent.children.setdefault(piece, _Node())
                key.append(piece)
            key = tuple(key)
            if node.entry is not None:      # refresh recency, keep original
                self._lru.move_to_end(key)
                return True
            node.entry, node.nbytes, node.length = host, nbytes, n
            self._lru[key] = node
            self.nbytes += nbytes
            self.insertions += 1
            self._evict_over_budget()
            self._publish()
        return True

    def _evict_over_budget(self):
        while self.nbytes > self.budget and self._lru:
            key, node = self._lru.popitem(last=False)
            self._drop(key, node)
            # a restore chain needs every link: descendants of an evicted
            # node are unreachable, so cascade rather than leak dead bytes
            for dkey, dnode in self._descendant_entries(key, node):
                if dkey in self._lru:
                    del self._lru[dkey]
                    self._drop(dkey, dnode)

    def _drop(self, key: tuple, node: "_Node"):
        self.nbytes -= node.nbytes
        node.entry, node.nbytes, node.length = None, 0, 0
        self._prune(key)
        self.evictions += 1

    def _descendant_entries(self, key: tuple, node: "_Node"):
        out = []
        stack = [(key, node)]
        while stack:
            k, nd = stack.pop()
            for piece, child in nd.children.items():
                ck = k + (piece,)
                if child.entry is not None:
                    out.append((ck, child))
                stack.append((ck, child))
        return out

    def _prune(self, key: tuple):
        """Drop entry-less leaf nodes along ``key`` so the trie doesn't
        accumulate dead branches after evictions."""
        path = [self._root]
        for piece in key:
            nxt = path[-1].children.get(piece)
            if nxt is None:
                return
            path.append(nxt)
        for i in range(len(key), 0, -1):
            node = path[i]
            if node.entry is None and not node.children:
                del path[i - 1].children[key[i - 1]]
            else:
                break

    # -- carry across pool generations ------------------------------------
    def adopt_entries(self, other: "PrefixCache") -> int:
        """Carry entries from a predecessor pool's cache (the successor
        adopts). Entries are host-side and device-agnostic, so they stay
        valid across placement changes; a chunk-size mismatch
        makes boundaries incoherent, so everything is dropped instead.
        Returns the number of entries adopted."""
        if other is None or other is self or other.chunk != self.chunk:
            # `other is self`: a fleet-shared cache carried across a resize
            # adopts from itself — nothing to copy
            return 0
        with other._lock:
            items = [(key, node.entry) for key, node in other._lru.items()
                     if node.entry is not None]
        n = 0
        # ancestors first: recency order can put a child link before its
        # parent (a partial lookup touches only the covered prefix), and
        # insert() refuses chain-broken keys — inserting by key depth keeps
        # every chain intact
        for key, entry in sorted(items, key=lambda kv: len(kv[0])):
            toks = [t for piece in key for t in piece]
            if self.insert(toks, entry):
                n += 1
        with self._lock:                # then replay the source's recency
            for key, _ in items:
                if key in self._lru:
                    self._lru.move_to_end(key)
        return n

    # -- introspection -----------------------------------------------------
    def _publish(self):
        if self.monitor is not None:
            self.monitor.gauge(self.name, "prefix_cache_hits", self.hits)
            self.monitor.gauge(self.name, "prefix_cache_misses", self.misses)
            self.monitor.gauge(self.name, "prefix_cache_evictions",
                               self.evictions)
            self.monitor.gauge(self.name, "prefix_cache_bytes", self.nbytes)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "insertions": self.insertions,
                    "entries": len(self._lru), "bytes": self.nbytes,
                    "hit_tokens": self.hit_tokens,
                    "hit_rate": self.hits / total if total else None}

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)
