"""Bring the JAX package's state into the port.

``from_jax`` takes arrays of auto_oo_tpu — ``theta``, ``oao_mo_coeff``,
a ``GridMaps``' tables — as numpy arrays (or anything ``np.asarray``
accepts, which includes jax arrays without importing jax here) and
returns the port's tensors, so both packages can start from the same
state.
"""

from collections.abc import Mapping

import numpy as np
import torch

from ..config import get_device
from ..ops.grid import GridMaps

_GRID_FIELDS = ("srcA", "sgnA", "tB", "srcB", "sgnB", "tA", "g2s", "s2g")


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, device=device).to(dtype)
    return torch.as_tensor(a, device=device)


def from_jax(arrays, device=None, dtype=torch.float64):
    """Convert JAX-package state to the port's tensors on ``device``.

    ``arrays`` is one array or a mapping of name to array.  Floating
    arrays become ``dtype``; integer arrays keep their type.  A mapping
    (or a namedtuple, via ``_asdict``) holding the eight GridMaps tables
    (srcA, sgnA, tB, srcB, sgnB, tA, g2s, s2g) becomes a port
    ``GridMaps`` whose sign tables are in ``dtype``."""
    device = get_device(device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    if isinstance(arrays, Mapping):
        if set(_GRID_FIELDS) <= set(arrays):
            return GridMaps(**{k: np.asarray(arrays[k])
                               for k in _GRID_FIELDS},
                            device=device, dtype=dtype)
        return {k: _tensor(v, device, dtype) for k, v in arrays.items()}
    return _tensor(arrays, device, dtype)
