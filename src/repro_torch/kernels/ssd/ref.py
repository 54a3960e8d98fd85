"""Plain PyTorch version of the SSD intra-chunk kernel, the same arithmetic
as the JAX package's ``_ssd_kernel``: the full (c x c) decay matrix is
formed, and its backward by autograd and in closed form. The wrapper uses
the forward for CPU tensors (autograd differentiates it there), and the
on-card checks hold the CUDA kernels against the forward and the autograd
backward."""
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


def ssd_intra_chunk_closed_bwd(a, xdt, B, C, dy, dS):
    """The backward in closed form, in the CUDA kernels' order: per (batch,
    chunk, head) dM = dy·xdtᵀ on the causal triangle, P = dM∘M and q; the
    heads' dG = Σ_h dM∘L summed in head order; da by a reverse cumsum.
    Returns (da, dxdt, dB, dC) as ``ssd_intra_chunk_ref_bwd`` does."""
    c = a.shape[-1]
    acs = torch.cumsum(a, dim=-1)
    causal = torch.ones((c, c), dtype=torch.bool, device=a.device).tril()
    diff = acs[..., :, None] - acs[..., None, :]
    L = torch.exp(diff.masked_fill(~causal, float("-inf")))
    M = torch.einsum("bncs,bnks->bnck", C, B)[:, None] * L
    w = torch.exp(acs[..., -1:] - acs)
    dM = torch.einsum("bhnip,bhnjp->bhnij", dy, xdt) * causal
    P = dM * M
    wU = w[..., None] * torch.einsum("bncs,bhnsp->bhncp", B, dS)
    q = (wU * xdt).sum(-1)
    dxdt = torch.einsum("bhnij,bhnip->bhnjp", M, dy) + wU
    dacs = P.sum(-1) - P.sum(-2) - q
    dacs[..., -1] += q.sum(-1)
    da = dacs.flip(-1).cumsum(-1).flip(-1)
    dGh = dM * L
    dG = dGh[:, 0]
    for h in range(1, dGh.shape[1]):
        dG = dG + dGh[:, h]
    dC = dG @ B
    dB = dG.transpose(-1, -2) @ C + torch.einsum(
        "bhnj,bhnjp,bhnsp->bnjs", w, xdt, dS)
    return da, dxdt, dB, dC
