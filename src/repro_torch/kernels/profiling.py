"""Which device kernels one call launches, from ``torch.profiler``: the
card checks use it to hold a wrapper to the grids it should launch."""

from __future__ import annotations

from typing import Callable


def device_kernels(fn: Callable[[], object]) -> dict[str, tuple[float, int]]:
    """The device kernels of one call of ``fn`` by name, ``{name: (ms,
    calls)}``. The profiler runs one warm-up step of its own (a call of
    ``fn`` it does not record) before the recorded call: a profile that
    starts cold has been seen to lose the record of a call's first kernel.
    The profiler's mark of its step is not device work and is left out.
    ``fn`` runs twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: got.extend(p.events())) as prof:
        for _ in range(2):
            fn()
            if on_card:
                torch.cuda.synchronize()
            prof.step()
    by_name: dict[str, tuple[float, int]] = {}
    for e in got:
        if e.device_type == DeviceType.CUDA and \
                not e.name.startswith("ProfilerStep"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name
