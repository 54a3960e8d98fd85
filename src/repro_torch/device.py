"""Device choice for the port's entry points: the card, unless the caller
asks for another device. There is no silent fallback to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device,
    and raises when there is none. A CUDA device always gets its index (the
    decode thread pins it with ``torch.cuda.set_device``)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError('no CUDA device is available: pass device="cpu" to '
                       'run on the CPU')
