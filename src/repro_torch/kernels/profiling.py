"""Which device kernels one call launches, from ``torch.profiler``: the
card checks use it to hold a wrapper to the grids it should launch."""

from __future__ import annotations

import time
from typing import Callable

# Host seconds left idle on each side of the recorded call. The profiler
# keeps a device record only if its start and end, converted to the host's
# clock, lie inside the recorded step, and that conversion has put kernels
# up to ~5 ms before the moment their launch allowed: with no idle time a
# few profiles in a hundred lose some or all of the call's kernels
# (``tools/profile_drops.py`` measures how often, with and without this).
HOST_GUARD_S = 0.05


def recorded_events(fn: Callable[[], object], guard_s: float | None = None):
    """The profiler's events of one call of ``fn``: one warm-up step of its
    own (a call of ``fn`` it does not record) comes first, since a profile
    that starts cold has lost the record of a call's first kernel, and the
    recorded call is kept ``guard_s`` (default ``HOST_GUARD_S``) apart
    from the step's edges. ``fn`` runs twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    guard = HOST_GUARD_S if guard_s is None else guard_s
    got = []
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.extend(p.events())) as prof:
        for _ in range(2):
            time.sleep(guard)
            fn()
            if on_card:
                torch.cuda.synchronize()
            time.sleep(guard)
            prof.step()
    return got


def device_kernels(fn: Callable[[], object],
                   guard_s: float | None = None) -> dict[str, tuple[float, int]]:
    """The device kernels of one call of ``fn`` by name, ``{name: (ms,
    calls)}``, from ``recorded_events``. The profiler's mark of its step is
    not device work and is left out."""
    from torch.autograd import DeviceType

    by_name: dict[str, tuple[float, int]] = {}
    for e in recorded_events(fn, guard_s):
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("ProfilerStep"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name
