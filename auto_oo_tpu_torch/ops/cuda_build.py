"""Build and load the port's CUDA kernel libraries.

Each ``csrc/*.cu`` source has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` at first use into the git-ignored ``build/``
directory at the repository root, keyed by a hash of the source, and
loaded with ctypes.  There is no fallback: a missing ``nvcc`` or a
failed build raises.

:func:`load_all` starts one ``nvcc`` per source at once, so a program
that needs several libraries waits for the slowest build only.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ..config import BUILD_DIR

#: the port's CUDA sources
CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

# the CUDA toolkit's default location, used when nvcc is not on PATH
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

#: ctypes argument types of the C entry points
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc(src):
    path = shutil.which("nvcc")
    if path is None and os.path.exists(_NVCC_DEFAULT):
        path = _NVCC_DEFAULT
    if path is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernels are built from {src} at "
            "first use on a CUDA tensor")
    return path


class CudaLibrary:
    """One CUDA source, built at first use and loaded with ctypes.

    ``symbols`` maps each C entry point to its argtypes; every entry
    point returns an int (the ``cudaError_t`` of its launch)."""

    def __init__(self, src, symbols):
        self.src = src
        self.symbols = symbols
        self.lib = None

    def _target(self):
        with open(self.src, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        stem = os.path.splitext(os.path.basename(self.src))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{tag}.so")

    def _start(self):
        """Start nvcc unless the library is built; returns (path, job)."""
        out = self._target()
        if os.path.exists(out):
            return out, None
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a private name, then rename: concurrent processes never
        # load a half-written library
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(self.src), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, self.src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return out, (proc, tmp)

    def _finish(self, started):
        out, job = started
        if job is not None:
            proc, tmp = job
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {self.src}:\n"
                    f"{stdout}\n{stderr}")
            os.replace(tmp, out)
        return out

    def build(self):
        """Compile the source (if not built yet) and return the path of
        the shared library.  Raises on a missing nvcc or a failed build."""
        return self._finish(self._start())

    def _load(self, path):
        lib = ctypes.CDLL(path)
        for name, argtypes in self.symbols.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib = lib

    def load(self):
        """Build (if needed) and load; returns the seconds this call took
        (0 when already loaded)."""
        if self.lib is not None:
            return 0.0
        t0 = time.perf_counter()
        self._load(self.build())
        return time.perf_counter() - t0

    def launch(self, symbol, *args):
        """Call one entry point; raises if it reports a CUDA error."""
        self.load()
        code = getattr(self.lib, symbol)(*args)
        if code != 0:
            raise RuntimeError(f"{symbol} launch failed: cudaError {code}")


def load_all(libraries):
    """Build every library not loaded yet, one nvcc per source started
    together, then load them; returns the seconds taken.  A failed build
    raises after the other builds are stopped."""
    t0 = time.perf_counter()
    todo = [lib for lib in libraries if lib.lib is None]
    started = []
    try:
        for lib in todo:
            started.append(lib._start())
        for lib, st in zip(todo, started):
            lib._load(lib._finish(st))
    finally:
        for _, job in started:
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].communicate()
    return time.perf_counter() - t0
