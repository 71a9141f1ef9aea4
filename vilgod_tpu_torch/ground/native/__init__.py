"""The C++ Patchwork++ oracle of the ground stage, bound with ctypes; the
port's copy of ``vilgod_tpu/ground/native``.

``patchwork.cpp`` is the JAX package's source, its code unchanged (a
comment names the reference's fork by its name alone): host C++ (RNR,
concentric-zone binning, per-patch z-sort, R-VPF/R-GPF plane fits, GLE,
TGR, A-GLE adaptive thresholds), the reference's algorithm written
without Eigen. It is an oracle, not a kernel: it runs on numpy arrays on
the CPU whatever device the pipeline runs on, and the tests and
``chip_smoke.py`` hold ``ground.segment_ground`` to it.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use into ``build/native/`` of the checkout, named by a hash of the source
and the flags, so an edited source builds anew and nothing is written next
to the source. Each build goes to a temporary file of that directory and
is renamed into place, so processes that build at once each load a whole
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "patchwork.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return Path(BUILD_DIR) / f"libpatchwork_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> Path:
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.stem + ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library():
    """The oracle's shared library, built on first use, its C functions'
    signatures set."""
    path = library_path()
    with _lock:
        if path not in _libs:
            lib = ctypes.CDLL(str(_build(path)))
            lib.pw_create.restype = ctypes.c_void_p
            lib.pw_create.argtypes = [ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int]
            lib.pw_destroy.argtypes = [ctypes.c_void_p]
            lib.pw_segment.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte),
            ]
            lib.pw_sensor_height.restype = ctypes.c_double
            lib.pw_sensor_height.argtypes = [ctypes.c_void_p]
            _libs[path] = lib
        return _libs[path]


class NativePatchwork:
    """Stateful native ground segmenter: the adaptive thresholds and the
    sensor height persist across ``segment`` calls, as in the C++
    reference."""

    def __init__(self, cfg=None):
        from ..patchwork import GroundConfig

        cfg = cfg or GroundConfig()
        lib = load_library()
        params = np.array(
            [
                float(cfg.enable_rnr), float(cfg.enable_rvpf), float(cfg.enable_tgr),
                cfg.num_iter, cfg.num_lpr, cfg.num_min_pts, cfg.num_rings_of_interest,
                cfg.rnr_ver_angle_thr, cfg.rnr_intensity_thr, cfg.sensor_height,
                cfg.th_seeds, cfg.th_dist, cfg.th_seeds_v, cfg.th_dist_v,
                cfg.max_range, cfg.min_range, cfg.uprightness_thr,
                cfg.adaptive_seed_selection_margin,
            ],
            dtype=np.float64,
        )
        self._lib = lib
        self._h = lib.pw_create(
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(params))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pw_destroy(self._h)
            self._h = None

    @property
    def sensor_height(self) -> float:
        return float(self._lib.pw_sensor_height(self._h))

    def segment(self, points: np.ndarray) -> np.ndarray:
        """points (N, 4+) [x, y, z, intensity, ...] -> ground mask (N,)."""
        points = np.asarray(points)
        if points.ndim != 2 or points.shape[1] < 4:
            raise ValueError(f"segment: points must be (N, 4+), got "
                             f"{points.shape}")
        pts = np.ascontiguousarray(points[:, :4], dtype=np.float32)
        out = np.zeros(len(pts), np.uint8)
        self._lib.pw_segment(
            self._h,
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pts),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        return out.astype(bool)


__all__ = ["NativePatchwork", "load_library"]
