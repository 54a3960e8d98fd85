"""Workflow system (Luigi/Pachyderm analogue): DAGs of short-lived tool tasks.

The paper's parallelization pattern (§5.1): split the data into N partitions,
run one containerized-tool replica per partition, gather. ``Workflow.map_
partitions`` is that pattern as a first-class primitive; tasks are idempotent
(keyed), retried on failure, and scheduled by ``repro_torch.core.scheduler``.

A copy of the JAX package's ``repro.core.workflow`` (framework-free).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ToolTask:
    """A short-lived service: runs, produces a result, exits."""
    name: str
    fn: Callable[..., Any]
    deps: List[str] = dataclasses.field(default_factory=list)
    args: tuple = ()
    group: str = ""                  # speculation statistics pool
    retries: int = 2

    @property
    def key(self) -> str:
        return hashlib.sha1(self.name.encode()).hexdigest()[:12]


class Workflow:
    def __init__(self, name: str):
        self.name = name
        self.tasks: Dict[str, ToolTask] = {}

    def add(self, name: str, fn: Callable, deps: Sequence[str] = (),
            args: tuple = (), group: str = "", retries: int = 2) -> str:
        if name in self.tasks:
            raise KeyError(f"duplicate task {name}")
        self.tasks[name] = ToolTask(name, fn, list(deps), tuple(args),
                                    group or name.split(":")[0], retries)
        return name

    def map_partitions(self, stage: str, tool: Callable, data: np.ndarray,
                       n_partitions: int, deps: Sequence[str] = (),
                       reducer: Optional[Callable] = None) -> str:
        """The paper's tool-parallelization: split -> N tool tasks -> gather.

        ``tool(partition) -> result``; gather task returns
        ``reducer(results)`` (default: list of results in partition order).
        """
        parts = np.array_split(data, n_partitions)
        part_names = []

        def tool_barrier(part, *_dep_barrier_values):
            # upstream deps act as barriers; tools see only their partition
            return tool(part)

        for i, part in enumerate(parts):
            nm = f"{stage}:part{i}"
            self.add(nm, tool_barrier, deps=deps, args=(part,), group=stage)
            part_names.append(nm)

        def gather(*results):
            if reducer is not None:
                return reducer(list(results))
            return list(results)

        gname = f"{stage}:gather"
        self.add(gname, gather, deps=part_names, group=stage + ".gather")
        return gname

    # -- graph utilities --------------------------------------------------
    def toposort(self) -> List[str]:
        order, seen, visiting = [], set(), set()

        def visit(n):
            if n in seen:
                return
            if n in visiting:
                raise ValueError(f"cycle at {n}")
            visiting.add(n)
            for d in self.tasks[n].deps:
                if d not in self.tasks:
                    raise KeyError(f"task {n} depends on unknown {d}")
                visit(d)
            visiting.discard(n)
            seen.add(n)
            order.append(n)

        for n in self.tasks:
            visit(n)
        return order

    def run_local(self) -> Dict[str, Any]:
        """Single-threaded reference executor (oracle for scheduler tests)."""
        results: Dict[str, Any] = {}
        for name in self.toposort():
            t = self.tasks[name]
            dep_vals = [results[d] for d in t.deps]
            results[name] = t.fn(*t.args, *dep_vals)
        return results
