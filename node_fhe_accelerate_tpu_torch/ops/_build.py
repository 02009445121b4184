"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/kernels/<name>_<tag>.so`` beside the package (listed in
.gitignore), loaded with ctypes.  The tag hashes every file the build reads
(the source and all shared headers), so a changed header never loads a
stale library.  A library is built at first use; ``build_all`` starts every
``nvcc`` at once.  A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelLibrary", "build_all"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """One CUDA source and the C functions it exports.

    ``functions`` maps each exported name to its ctypes argument types;
    every function returns a ``cudaError_t`` as int.  ``info`` holds the
    build's wall seconds and the compiler's output (``ptxas -v`` lines) when
    this process built the library, else ``seconds`` is None."""

    def __init__(self, source: str, functions: dict[str, list]):
        self.source = _CSRC / source
        self.name = self.source.stem
        self.functions = functions
        self.info: dict = {"seconds": None, "log": ""}
        self._lib = None
        self._proc = None
        self._t0 = 0.0

    def _target(self) -> Path:
        h = hashlib.sha256()
        for path in [self.source] + sorted(_CSRC.glob("*.cuh")):
            h.update(path.name.encode())
            h.update(path.read_bytes())
        return _BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"

    def _tmp(self, so: Path) -> Path:
        return so.with_name(f"{so.name}.{os.getpid()}.tmp")

    def start(self) -> None:
        """Start ``nvcc`` for this source unless the library is loaded,
        already built, or being built."""
        so = self._target()
        if self._lib is not None or self._proc is not None or so.exists():
            return
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(self._tmp(so)), str(self.source)]
        self._t0 = time.perf_counter()
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if need be."""
        if self._lib is not None:
            return self._lib
        self.start()
        so = self._target()
        if self._proc is not None:
            proc, self._proc = self._proc, None
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{log}")
            os.replace(self._tmp(so), so)
            self.info.update(seconds=time.perf_counter() - self._t0, log=log)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib = lib
        return lib


def build_all(libraries) -> None:
    """Build and load several libraries, their compilers running side by
    side."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.load()
