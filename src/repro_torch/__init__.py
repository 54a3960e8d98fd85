"""PyTorch/CUDA port of the ``repro`` package (the JAX package is the
reference). Imports torch, never jax, and nothing of ``repro``."""
