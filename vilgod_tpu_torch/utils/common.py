"""Small shared utilities of the port: its device rule, the float32
fused multiply-add of XLA's CPU backend, and its own copies of the helpers
of ``vilgod_tpu/utils/common.py`` (logging, seeding, affinity-matrix
grouping, vector angles, box interpolation) that the run tool needs."""
from __future__ import annotations

import logging
import random
from pathlib import Path

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Without a card, ``cuda`` raises instead of quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vilgod_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU backend fuses a
    product into the sum that follows it: the product of two f32 is exact
    in float64, so only the f64 sum and its f32 rounding round (double
    rounding differs from a true fused multiply-add about once in 2**29).
    The same torch ops give the same bits on the card."""
    return (a.double() * b.double() + c.double()).float()


def flatten(xss):
    return [x for xs in xss for x in xs]


def set_random_seed(seed: int):
    """Seed Python's ``random``, numpy and torch (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def create_logger(name: str = "vilgod_tpu_torch",
                  level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(levelname)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def print_separator(logger, separator: str = "_", length: int = 80):
    logger.info(separator * length)
    logger.info("")


def build_number_file_path(dir_path: Path, number: int, postfix=".pkl",
                           n_zeros: int = 4) -> Path:
    return Path(dir_path) / f"{number:0{n_zeros}d}{postfix}"


def check_and_create_dir(dir_path: Path) -> bool:
    """Create ``dir_path`` (and its parents) where it is missing; True when
    it had to be created."""
    dir_path = Path(dir_path)
    requires = not dir_path.exists()
    if requires:
        dir_path.mkdir(parents=True, exist_ok=True)
    return requires


def extract_groups(matrix) -> list[set]:
    """Group the nonzero cells of an affinity matrix into connected
    components, cells connecting through shared rows and columns; an
    iterative search (no recursion limit)."""
    m = np.asarray(matrix)
    n_rows, n_cols = m.shape
    visited = np.zeros(m.shape, bool)
    groups = []
    for i in range(n_rows):
        for j in range(n_cols):
            if m[i, j] > 0 and not visited[i, j]:
                group = set()
                stack = [(i, j)]
                while stack:
                    a, b = stack.pop()
                    if visited[a, b] or m[a, b] == 0:
                        continue
                    visited[a, b] = True
                    group.add((a, b))
                    stack.extend((x, b) for x in range(n_rows)
                                 if m[x, b] > 0 and not visited[x, b])
                    stack.extend((a, y) for y in range(n_cols)
                                 if m[a, y] > 0 and not visited[a, y])
                groups.append(group)
    return groups


def angle_between_vectors(v1, v2) -> float:
    """Angle in degrees, the cosine clipped to +/-0.9999."""
    cos = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.rad2deg(np.arccos(np.clip(cos, -0.9999, 0.9999))))


def interpolate_bounding_boxes(boxes: np.ndarray, indices,
                               length: int) -> np.ndarray:
    """Linear interpolation of (N, 7) box parameters over ``length``
    frames from the frames ``indices``, the heading through its sine and
    cosine."""
    boxes = np.asarray(boxes)
    out = np.zeros((length, 7))
    xs = np.arange(length)
    for i in range(6):
        out[:, i] = np.interp(xs, indices, boxes[:, i])
    cos_i = np.interp(xs, indices, np.cos(boxes[:, 6]))
    sin_i = np.interp(xs, indices, np.sin(boxes[:, 6]))
    out[:, 6] = np.arctan2(sin_i, cos_i)
    return out
