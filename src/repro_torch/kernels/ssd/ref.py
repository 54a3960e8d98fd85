"""Plain PyTorch version of the SSD intra-chunk kernel, the same arithmetic
as the JAX package's ``_ssd_kernel``: the full (c x c) decay matrix is
formed, and its backward by autograd. The wrapper uses the forward for CPU
tensors (autograd differentiates it there), and the on-card checks hold the
CUDA kernels against both."""
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


def ssd_intra_chunk_ref_bwd(a, xdt, B, C, dy, dS):
    """The plain backward: (da, dxdt, dB, dC) of ``ssd_intra_chunk_ref``
    for the output gradients ``dy`` (of y_intra) and ``dS`` (of S_local),
    by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (a, xdt, B, C)]
        y, S = ssd_intra_chunk_ref(*ins)
        return torch.autograd.grad((y, S), ins, (dy, dS))
