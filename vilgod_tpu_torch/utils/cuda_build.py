"""The port's one CUDA build step: each ``csrc/*.cu`` is compiled with nvcc
for sm_90a into its own shared library under ``build/kernels/`` (once per
source content and flags) and bound with ctypes.

Every source has a plain C interface, so nvcc builds it in seconds; no
PyTorch header is included. Nothing is built at import: a library builds
at the first launch of one of its kernels, or up front with
:func:`build_all`, which starts one nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
# this process's nvcc builds started and libraries loaded, by source name
# (a warm pipeline run starts and loads none: tools/soak.py holds it)
BUILDS: dict[str, int] = {}
LOADS: dict[str, int] = {}


def source_files(source: Path) -> list[Path]:
    """``source`` and every header it includes by a quoted ``#include``
    beside it, recursively, each once."""
    files, todo = [], [Path(source)]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        todo += [f.parent / m.decode() for m in _INCLUDE.findall(
            f.read_bytes()) if (f.parent / m.decode()).exists()]
    return files


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the port's kernels build from "
                       f"{CSRC} with the CUDA toolkit")


class CudaLibrary:
    """One ``csrc`` source, its nvcc flags and its C functions' ctypes
    signatures (each returns an int: 0, or the CUDA error of its launch)."""

    def __init__(self, source: str, signatures: dict, extra_flags=()):
        self.source = CSRC / source
        self.signatures = signatures
        self.flags = (*BASE_FLAGS, *extra_flags)
        self._lib = None
        self._lock = threading.Lock()

    @property
    def path(self) -> Path:
        """The library's path, named by a hash of the source, the headers
        it includes and the flags (an edited header builds anew)."""
        h = hashlib.sha256()
        for f in source_files(self.source):
            h.update(f.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc on the source unless the library exists; returns
        ``(process, temporary output)`` or None."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        BUILDS[self.source.name] = BUILDS.get(self.source.name, 0) + 1
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), tmp

    def finish_build(self, started) -> Path:
        """Wait for a build from :meth:`start_build`; the ptxas report
        (registers, shared memory, spills) lands beside the library as
        ``.log``."""
        if started is not None:
            proc, tmp = started
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{err}")
            self.path.with_suffix(".log").write_text(out + err)
            os.replace(tmp, self.path)
        return self.path

    def build(self) -> Path:
        return self.finish_build(self.start_build())

    def load(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                LOADS[self.source.name] = LOADS.get(self.source.name, 0) + 1
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def build_all(libraries) -> list[Path]:
    """Build several libraries at once: one nvcc each, all started before
    any is waited for."""
    started = [lib.start_build() for lib in libraries]
    return [lib.finish_build(s) for lib, s in zip(libraries, started)]


def launch(fn, *args):
    """Call a C launcher; raise if CUDA refused or failed the launch."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error {err}")


def stream_of(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
