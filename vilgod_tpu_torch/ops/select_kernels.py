"""The clustering stage's input selection: a CUDA wrapper, its plain
PyTorch version, the frame windows they share and a launch count.

Page i of a clustering chunk (frame ``fnr = f0 + i``) clusters the
``nfw`` frames of its window, which starts at ``fnr`` clamped into
``[0, max(f_real - nfw, 0)]``. Each window frame ``rel`` keeps a point by
the rule of the JAX package's ``select_cluster_input``
(``vilgod_tpu/pipeline/stages_geometry.py``): a Bernoulli(1/nfw) draw
from ``fold_in(fold_in(PRNGKey(seed), fnr), rel)`` among the points with
a neighbour, and among the moving points (``entropy_mask``) exactly the
dense ones. The JAX package runs it under ``vmap``; it has no Pallas
kernel.

:func:`select_keep` takes its plain version only for CPU tensors. For
CUDA tensors it launches ``select_keep`` from ``csrc/select.cu`` (built
by ``utils/cuda_build.py`` at first use), one launch a chunk, bit for bit
the plain version's mask, or raises; it never falls back. ``LAUNCHES``
counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from ..utils.cuda_build import CudaLibrary, launch, stream_of
from . import random as jrandom

KERNEL_NAMES = ("select_keep",)
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def page_keys(seed: int, f0: int, chunk: int, nfw: int) -> list:
    """The draw keys of pages ``f0 .. f0 + chunk - 1``, page-major: one
    ``fold_in(fnr)`` a page, one ``fold_in(rel)`` a window frame, in
    Python integers (no tensor, no device)."""
    base = jrandom.PRNGKey(seed)
    keys = []
    for fnr in range(f0, f0 + chunk):
        page = jrandom.fold_in(base, fnr)
        keys += [jrandom.fold_in(page, rel) for rel in range(nfw)]
    return keys


def window_frames(f0: int, chunk: int, nfw: int, f_real: int,
                  n_frames: int, device):
    """Each page's window on ``device``, made there (no upload): (lo
    (chunk,) its first frame, frames (chunk, nfw) each window frame
    clamped to the buffer, valid (chunk, nfw) where that frame is real and
    unclamped), int64, int64, bool."""
    lo = torch.clamp(torch.arange(f0, f0 + chunk, device=device), 0,
                     max(f_real - nfw, 0))
    want = lo[:, None] + torch.arange(nfw, device=device)
    frames = torch.clamp(want, max=n_frames - 1)
    return lo, frames, (frames < f_real) & (want == frames)


def keep_plain(keys, mask, has_nbr, dense_moving, entropy_mask, f0: int,
               nfw: int, f_real: int) -> torch.Tensor:
    """The chunk's keep mask (chunk, nfw * n) bool, page-major: the JAX
    package's per-window rule over the (n_frames, n) masks."""
    n_frames, n = mask.shape
    chunk = len(keys) // nfw
    _, frames, valid = window_frames(f0, chunk, nfw, f_real, n_frames,
                                     mask.device)
    valid = valid[..., None]
    draw = jrandom.uniform_rows(keys, n, mask.device).reshape(chunk, nfw, n)
    m = mask[frames] & valid
    keep = (draw < (1.0 / nfw)) & m & has_nbr[frames]
    keep = torch.where(entropy_mask[frames] & valid,
                       dense_moving[frames] & m, keep)
    return keep.reshape(chunk, nfw * n)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# -fmad=false as every source of the port (the kernel's one float
# subtraction is exact and its compare rounds nothing)
LIBRARY = CudaLibrary("select.cu", {
    # the (page, window frame) keys a launch takes
    "select_max_keys": (),
    # keys, pages, page0, mask, has_nbr, dense_moving, entropy_mask, n,
    # n_frames, f_real, f0, nfw, threshold, keep, stream
    "select_keep": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
                    _P),
}, extra_flags=("-fmad=false",))


def select_keep(keys, mask, has_nbr, dense_moving, entropy_mask, f0: int,
                nfw: int, f_real: int) -> torch.Tensor:
    """The keep mask (chunk, nfw * n) bool of the pages whose draw keys
    ``keys`` (:func:`page_keys`) holds, over the (n_frames, n) bool
    ``mask`` and selection statistics: :func:`keep_plain` on the CPU; on
    the card one launch of the fused kernel for every 256 keys (one a
    chunk of 32 pages of two frames), on the device's current stream,
    counted as ``LAUNCHES`` and, while recording, as counter
    ``select_draws``."""
    name = "select_keep"
    masks = (mask, has_nbr, dense_moving, entropy_mask)
    n_frames, n = mask.shape
    if any(t.dtype != torch.bool or t.shape != mask.shape for t in masks):
        raise TypeError(f"{name}: the masks must be ({n_frames}, {n}) bool, "
                        f"got {[(t.dtype, tuple(t.shape)) for t in masks]}")
    if nfw <= 0 or not keys or len(keys) % nfw:
        raise ValueError(f"{name}: {len(keys)} keys are no whole pages of "
                         f"{nfw} window frames")
    if not 0 < n_frames * n < 2 ** 31:
        raise ValueError(f"{name}: needs n_frames * n < 2**31, got "
                         f"{n_frames} x {n}")
    if not mask.is_cuda:
        return keep_plain(keys, *masks, f0, nfw, f_real)
    masks = [t.contiguous() for t in masks]
    lib = LIBRARY.load()
    per = lib.select_max_keys() // nfw
    if per == 0:
        raise ValueError(f"{name}: {nfw} window frames exceed the "
                         f"{lib.select_max_keys()} keys of a launch")
    chunk = len(keys) // nfw
    keep = torch.empty((chunk, nfw * n), dtype=torch.bool,
                       device=mask.device)
    words = [w for k in keys for w in k]
    with torch.cuda.device(mask.device):
        for page0 in range(0, chunk, per):
            pages = min(per, chunk - page0)
            part = words[2 * nfw * page0:2 * nfw * (page0 + pages)]
            launch(lib.select_keep, (ctypes.c_uint * len(part))(*part),
                   pages, page0, *(t.data_ptr() for t in masks), n,
                   n_frames, f_real, f0, nfw, 1.0 / nfw, keep.data_ptr(),
                   stream_of(mask.device))
            LAUNCHES[name] += 1
            trace.count("select_draws")
    return keep
