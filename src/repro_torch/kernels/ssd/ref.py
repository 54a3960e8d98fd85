"""Plain PyTorch version of the SSD intra-chunk kernel, the same arithmetic
as the JAX package's ``_ssd_kernel``: the full (c x c) decay matrix is
formed. The wrapper uses it for CPU tensors, and the on-card check holds the
CUDA kernel against it."""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(a, xdt, B, C):
    """a: (b, nh, nc, c) log-decays; xdt: (b, nh, nc, c, hd); B/C:
    (b, nc, c, ds); all f32. Returns (y_intra (b, nh, nc, c, hd),
    S_local (b, nh, nc, ds, hd))."""
    c = a.shape[-1]
    acs = torch.cumsum(a, dim=-1)
    diff = acs[..., :, None] - acs[..., None, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=a.device).tril()
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    scores = torch.einsum("bncs,bnks->bnck", C, B)
    y = torch.einsum("bhnck,bhnkp->bhncp", scores[:, None] * L, xdt)
    decay_out = torch.exp(acs[..., -1:] - acs)
    S = torch.einsum("bncs,bhnc,bhncp->bhnsp", B, decay_out, xdt)
    return y, S
