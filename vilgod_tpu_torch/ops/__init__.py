"""Geometry kernel library of the port: banded and dense neighbour passes
(CUDA kernels with plain PyTorch versions), entropy, density clustering,
box geometry, by-label statistics and the jax.random-compatible draws."""
