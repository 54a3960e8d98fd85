"""Cluster scheduler for short-lived tool tasks: failure rescheduling +
straggler speculation.

Paper mapping (§3.1.2): the orchestrator "should manage container
replication ... and reschedule failed containers (possibly to different
nodes in case of VM failure)". Here:

  * N logical workers execute ready tasks (thread pool);
  * a task raising (or its worker being killed by the fault injector) is
    rescheduled on a different healthy worker, up to ``task.retries``;
  * straggler mitigation: when a task has run longer than
    ``speculation_factor`` x the median runtime of completed tasks in its
    group, a speculative replica is launched on another worker — first
    result wins (tasks must be idempotent, which workflow tools are).

A copy of the JAX package's ``repro.core.scheduler`` (framework-free).
"""
from __future__ import annotations

import queue
import random
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.core.monitoring import Monitor
from repro_torch.core.workflow import Workflow


class WorkerKilled(RuntimeError):
    pass


class Worker:
    def __init__(self, wid: int, speed: float = 1.0):
        self.wid = wid
        self.speed = speed              # <1.0: straggler (sleep scale)
        self.alive = True
        self.last_heartbeat = time.time()

    def heartbeat(self):
        self.last_heartbeat = time.time()
        return self.alive

    def execute(self, task, dep_vals):
        if not self.alive:
            raise WorkerKilled(f"worker {self.wid} is dead")
        if self.speed < 1.0:
            # straggler: artificially slow (simulates a degraded node)
            time.sleep(min(0.05, 0.005 / self.speed))
        result = task.fn(*task.args, *dep_vals)
        if not self.alive:
            raise WorkerKilled(f"worker {self.wid} died mid-task")
        return result


class ClusterScheduler:
    def __init__(self, num_workers: int = 4, monitor: Optional[Monitor] = None,
                 speculation_factor: float = 3.0, speculation_min_s: float = 0.02,
                 seed: int = 0):
        self.workers = [Worker(i) for i in range(num_workers)]
        self.monitor = monitor or Monitor()
        self.speculation_factor = speculation_factor
        self.speculation_min_s = speculation_min_s
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.stats = {"executed": 0, "failed": 0, "rescheduled": 0,
                      "speculative": 0, "speculative_wins": 0}

    # -- fault injection hooks -------------------------------------------
    def kill_worker(self, wid: int):
        self.workers[wid].alive = False
        self.monitor.log("scheduler", "worker.killed", worker=wid)

    def revive_worker(self, wid: int):
        self.workers[wid].alive = True

    def make_straggler(self, wid: int, speed: float = 0.1):
        self.workers[wid].speed = speed
        self.monitor.log("scheduler", "worker.straggler", worker=wid,
                         speed=speed)

    def healthy_workers(self):
        return [w for w in self.workers if w.alive]

    # -- execution ---------------------------------------------------------
    def run(self, wf: Workflow, max_parallel: Optional[int] = None
            ) -> Dict[str, Any]:
        order = wf.toposort()
        results: Dict[str, Any] = {}
        group_times: Dict[str, list] = {}
        remaining = {n: set(wf.tasks[n].deps) for n in order}
        done = threading.Event()
        results_lock = threading.Lock()
        errors: list = []
        inflight: Dict[str, dict] = {}
        ready: "queue.Queue[str]" = queue.Queue()
        queued = set()
        for n in order:
            if not remaining[n]:
                queued.add(n)
                ready.put(n)

        max_parallel = max_parallel or len(self.workers)

        def median(xs):
            s = sorted(xs)
            return s[len(s) // 2]

        def pick_worker(exclude=()):
            pool = [w for w in self.healthy_workers() if w.wid not in exclude]
            if not pool:
                raise RuntimeError("no healthy workers left")
            return self._rng.choice(pool)

        def attempt(name: str, speculative: bool, exclude=()):
            task = wf.tasks[name]
            with results_lock:
                dep_vals = [results[d] for d in task.deps]
            worker = pick_worker(exclude)
            t0 = time.perf_counter()
            info = {"worker": worker.wid, "start": t0,
                    "speculative": speculative}
            with self._lock:
                entry = inflight.setdefault(name, {"attempts": [],
                                                   "completed": False,
                                                   "failures": 0})
                entry["attempts"].append(info)
            try:
                value = worker.execute(task, dep_vals)
            except Exception as e:   # noqa: BLE001 — reschedule any failure
                self.stats["failed"] += 1
                self.monitor.log("scheduler", "task.failed", task=name,
                                 worker=worker.wid, error=repr(e))
                with self._lock:
                    entry = inflight[name]
                    if entry["completed"]:
                        return
                    entry["failures"] += 1
                    if entry["failures"] > task.retries:
                        errors.append((name, e))
                        done.set()
                        return
                    self.stats["rescheduled"] += 1
                pool.submit(attempt, name, speculative,
                            exclude=(worker.wid,))
                return
            dt = time.perf_counter() - t0
            with self._lock:
                entry = inflight[name]
                if entry["completed"]:
                    return           # lost the speculation race
                entry["completed"] = True
                if speculative:
                    self.stats["speculative_wins"] += 1
                self.stats["executed"] += 1
                group_times.setdefault(task.group, []).append(dt)
            with results_lock:
                results[name] = value
            self.monitor.log("scheduler", "task.done", task=name,
                             worker=worker.wid, seconds=dt,
                             speculative=speculative)
            # release dependents (atomically, so two deps finishing at
            # once can't double-enqueue a child)
            with self._lock:
                for child in order:
                    if name in remaining[child]:
                        remaining[child].discard(name)
                        if not remaining[child] and child not in queued:
                            queued.add(child)
                            ready.put(child)
            with results_lock:
                if len(results) == len(order):
                    done.set()

        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=max_parallel + 2)

        def speculation_daemon():
            while not done.is_set():
                time.sleep(0.01)
                now = time.perf_counter()
                with self._lock:
                    items = list(inflight.items())
                for name, entry in items:
                    if entry["completed"] or len(entry["attempts"]) > 1:
                        continue
                    task = wf.tasks[name]
                    times = group_times.get(task.group, [])
                    if len(times) < 2:
                        continue
                    med = median(times)
                    att = entry["attempts"][0]
                    run_t = now - att["start"]
                    if run_t > max(self.speculation_min_s,
                                   self.speculation_factor * med):
                        with self._lock:
                            self.stats["speculative"] += 1
                        self.monitor.log("scheduler", "task.speculate",
                                         task=name, runtime=run_t, median=med)
                        pool.submit(attempt, name, True,
                                    exclude=(att["worker"],))

        def dispatcher():
            while not done.is_set():
                try:
                    name = ready.get(timeout=0.02)
                except queue.Empty:
                    continue
                pool.submit(attempt, name, False)

        disp = threading.Thread(target=dispatcher, daemon=True)
        spec = threading.Thread(target=speculation_daemon, daemon=True)
        disp.start()
        spec.start()
        done.wait(timeout=120)
        pool.shutdown(wait=False, cancel_futures=True)
        if errors:
            name, e = errors[0]
            raise RuntimeError(f"task {name} exhausted retries: {e!r}") from e
        if len(results) != len(order):
            missing = set(order) - set(results)
            raise RuntimeError(f"workflow did not complete; missing {missing}")
        return results
