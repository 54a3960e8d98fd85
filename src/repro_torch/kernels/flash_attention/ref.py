"""Plain PyTorch version of the flash attention kernel: a materialised
softmax in f32 (O(S^2) memory). The wrapper uses it for CPU tensors, and the
on-card check holds the CUDA kernel against it."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B, S, H, D); k/v: (B, S, KV, D) with H % KV == 0 (q head h reads
    kv head h // (H // KV)). f32 scores, scale 1/sqrt(D), the same masks and
    softcap as the kernel; returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) * (
        1.0 / math.sqrt(d))
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
