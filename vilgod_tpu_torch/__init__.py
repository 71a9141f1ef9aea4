"""vilgod_tpu_torch: the PyTorch/CUDA port of ``vilgod_tpu``.

A second package beside the JAX one, run on an NVIDIA H100: plain tensor
code is PyTorch and every Pallas kernel of the JAX package on the ported
path is a CUDA C++ kernel under ``csrc/`` (see ``ops/kernels.py``). It
imports ``torch``, numpy and scipy only, never ``jax`` and nothing of
``vilgod_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; there the kernel wrappers take their plain PyTorch
versions.
"""
import torch as _torch

__version__ = "0.1.0"

# Geometry before speed, as in vilgod_tpu/__init__.py: every f32 product
# runs at full precision. TF32 keeps ~10 mantissa bits, which moves SE3
# transforms by millimetres at LiDAR magnitudes and flips eps-scale
# neighbour thresholds.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
