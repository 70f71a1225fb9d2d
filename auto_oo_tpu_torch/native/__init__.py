"""Native (C++) integral kernels: build-on-first-use via g++ + ctypes.

Host-side copy of auto_oo_tpu/native for the PyTorch port.  The library is
built from ``eri.cpp`` beside this file into the git-ignored ``build/``
directory at the repository root (keyed on a hash of the source), never
next to the source; without a compiler the numpy engine in
moldata/integrals.py computes the same tensor.
"""

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

from ..config import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build_lib():
    src = os.path.join(_DIR, "eri.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"libaoeri-{tag}.so")
    if not os.path.exists(out):
        # build to a private name, then rename: concurrent test workers
        # never load a half-written library
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-o", tmp, src]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build_lib()
        lib = ctypes.CDLL(path)
        lib.aoeri_compute.restype = None
        lib.aoeri_compute.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
        ]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as exc:
        warnings.warn(f"native ERI build failed ({exc}); "
                      "using the numpy engine")
        _LIB = None
    return _LIB


def eri_cart(shells):
    """Cartesian (ab|cd) tensor via the native engine, or None if
    unavailable.  `shells` is the moldata shell list; coefficients are
    pre-multiplied with primitive norms to match the Python engine."""
    lib = get_lib()
    if lib is None:
        return None
    from ..moldata.integrals import primitive_norm

    n = len(shells)
    ls = np.array([s.l for s in shells], dtype=np.int32)
    nprims = np.array([len(s.exps) for s in shells], dtype=np.int32)
    prim_offsets = np.zeros(n, dtype=np.int32)
    total = 0
    for i, s in enumerate(shells):
        prim_offsets[i] = total
        total += len(s.exps)
    exps = np.concatenate([s.exps for s in shells]).astype(np.float64)
    coefs = np.concatenate(
        [s.coefs * np.array([primitive_norm(s.l, a) for a in s.exps])
         for s in shells]).astype(np.float64)
    centers = np.concatenate([s.center for s in shells]).astype(np.float64)
    cart_offsets = np.zeros(n, dtype=np.int32)
    off = 0
    for i, s in enumerate(shells):
        cart_offsets[i] = off
        off += s.ncart
    out = np.zeros((off, off, off, off), dtype=np.float64)
    lib.aoeri_compute(n, ls, nprims, prim_offsets, exps, coefs,
                      np.ascontiguousarray(centers), cart_offsets, off,
                      out.reshape(-1))
    return out
