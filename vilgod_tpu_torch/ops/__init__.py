"""Geometry kernel library of the port: banded neighbour passes (CUDA
kernels with plain PyTorch versions), entropy, density clustering, by-label
statistics and the jax.random-compatible draws."""
