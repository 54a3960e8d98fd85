"""Device choice for the port's entry points: the card, unless the caller
asks for another device. There is no silent fallback to the CPU.

A VRE, a fleet and a replica pool partition a *device pool*. The pool is
a list of ``DeviceShare``s: ``device_pool(provider)`` gives one share per
visible card (or the host), and ``device_pool(provider, shares=N)`` gives N
distinct shares of each, so that one card can stand for a pool of N devices
(the counterpart of the JAX package's forced host device count). A share
is a token that grants, placements and slices are keyed on; it touches
hardware only through ``resolve_device``, which gives its card."""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch

PROVIDERS = ("cpu", "h100")
# the command line's share count (the JAX CLI forces a host device count
# through XLA_FLAGS instead)
SHARES_ENV = "REPRO_TORCH_DEVICE_SHARES"


@dataclasses.dataclass(frozen=True)
class DeviceShare:
    """Share ``index`` of ``device``: hashable, and distinct from every
    other share of the same card, so sets of shares stay disjoint."""
    device: torch.device
    index: int = 0

    def __str__(self) -> str:
        return f"{self.device}#{self.index}"


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; a ``DeviceShare`` gives its card;
    None means the current CUDA device, and raises when there is none. A
    CUDA device always gets its index (the decode thread pins it with
    ``torch.cuda.set_device``)."""
    if isinstance(device, DeviceShare):
        device = device.device
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError('no CUDA device is available: pass device="cpu" to '
                       'run on the CPU')


def provider_devices(provider: str) -> List[torch.device]:
    """The devices a provider offers: every visible card for ``"h100"``,
    the host for ``"cpu"``."""
    if provider == "cpu":
        return [torch.device("cpu")]
    if provider == "h100":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    raise ValueError(f"unknown provider {provider!r}: one of {PROVIDERS}")


def device_pool(provider: str = "h100",
                shares: Optional[int] = None) -> List[DeviceShare]:
    """The provider's device pool: ``shares`` (default 1) shares of each of
    its devices, card by card."""
    n = 1 if shares is None else int(shares)
    if n < 1:
        raise ValueError(f"device shares must be >= 1, got {n}")
    return [DeviceShare(d, i) for d in provider_devices(provider)
            for i in range(n)]


def shares_from_env() -> Optional[int]:
    """The share count ``SHARES_ENV`` asks for (None when unset)."""
    raw = os.environ.get(SHARES_ENV)
    if raw is None or raw == "":
        return None
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{SHARES_ENV} must be a positive integer, got "
                         f"{raw!r}")
    return n
