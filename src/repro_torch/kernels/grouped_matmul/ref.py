"""Plain PyTorch version of the grouped matmul kernel. The wrapper uses it
for CPU tensors, and the on-card check holds the CUDA kernel against it."""
from __future__ import annotations

import torch


def grouped_matmul_ref(x, w):
    """x: (E, C, d); w: (E, d, f) -> (E, C, f): the products in f32, rounded
    once to x's dtype (the JAX package's ``grouped_matmul_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
