"""Bring the JAX package's state into the port.

``from_jax`` takes arrays of auto_oo_tpu — ``theta``, ``oao_mo_coeff``,
a ``GridMaps``' tables, a ``GateProgram``'s host tables — as numpy
arrays (or anything ``np.asarray`` accepts, which includes jax arrays
without importing jax here) and returns the port's tensors or objects,
so both packages can start from the same state.  ``berry_loop_from_jax``
carries a JAX ``BerryPhaseLoop``'s trajectory into a port loop.
"""

from collections.abc import Mapping

import numpy as np
import torch

from ..config import get_device
from ..ops.grid import GridMaps
from ..simulator.gates import PairGate
from ..simulator.program import GateProgram

_GRID_FIELDS = ("srcA", "sgnA", "tB", "srcB", "sgnB", "tA", "g2s", "s2g")
_PROGRAM_FIELDS = ("ia", "ib", "sign", "half", "param", "n_params",
                   "init_idx", "dim")


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.floating):
        return torch.as_tensor(a, device=device).to(dtype)
    return torch.as_tensor(a, device=device)


def _program(prog, device):
    """The port's GateProgram of a JAX GateProgram: each gate's first
    ``n_real_pairs`` pairs of its padded rows (the JAX package pads a
    gate by repeating its first pair), with its display metadata."""
    half = np.asarray(prog.half, dtype=np.float64)
    ia, ib, sign = (np.asarray(getattr(prog, k)) for k in ("ia", "ib",
                                                           "sign"))
    n_real = (np.asarray(prog.n_real_pairs) if hasattr(prog, "n_real_pairs")
              else np.asarray(prog.mask).sum(axis=1).astype(np.int64))
    meta = getattr(prog, "gate_meta", None) or [(None, None, None)] * len(
        half)
    gates = [PairGate(ia[g, :k], ib[g, :k], sign[g, :k], half[g],
                      int(prog.param[g]), name=meta[g][0], wires=meta[g][1])
             for g, k in enumerate(int(k) for k in n_real)]
    return GateProgram(gates, prog.n_params, prog.init_idx, prog.dim,
                       device=device)


def from_jax(arrays, device=None, dtype=torch.float64):
    """Convert JAX-package state to the port's tensors on ``device``.

    ``arrays`` is one array or a mapping of name to array.  Floating
    arrays become ``dtype``; integer arrays keep their type.  A mapping
    (or a namedtuple, via ``_asdict``) holding the eight GridMaps tables
    (srcA, sgnA, tB, srcB, sgnB, tA, g2s, s2g) becomes a port
    ``GridMaps`` whose sign tables are in ``dtype``.  An object with a
    GateProgram's host tables (ia, ib, sign, half, param, n_params,
    init_idx, dim; the padded rows cut at n_real_pairs) becomes a port
    ``GateProgram``."""
    device = get_device(device)
    if all(hasattr(arrays, k) for k in _PROGRAM_FIELDS):
        return _program(arrays, device)
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    if isinstance(arrays, Mapping):
        if set(_GRID_FIELDS) <= set(arrays):
            return GridMaps(**{k: np.asarray(arrays[k])
                               for k in _GRID_FIELDS},
                            device=device, dtype=dtype)
        return {k: _tensor(v, device, dtype) for k, v in arrays.items()}
    return _tensor(arrays, device, dtype)


def berry_loop_from_jax(jloop, pqc):
    """A port ``BerryPhaseLoop`` over a JAX loop's geometries and problem,
    on ``pqc`` (the port's circuit of the same ansatz), holding the JAX
    loop's trajectory at every point: theta and oao_mo_coeff as tensors
    on ``pqc.device``, the energies, lowest Hessian eigenvalues, CASSCF
    energies and active indices as they are.  Its ``states`` and
    ``overlaps`` then run the port on the JAX package's (theta, oao)."""
    from ..models.berry import BerryPhaseLoop

    loop = BerryPhaseLoop(jloop.geometries, jloop.basis, jloop.ncas,
                          jloop.nelecas, pqc,
                          freeze_active=jloop.freeze_active,
                          newton_method=jloop.newton_method)
    loop.theta_l = [from_jax(np.array(t), pqc.device)
                    for t in jloop.theta_l]
    loop.oao_mo_coeff_l = [from_jax(np.array(c), pqc.device)
                           for c in jloop.oao_mo_coeff_l]
    loop.energy_l = [float(e) for e in jloop.energy_l]
    loop.hess_eig_l = [float(e) for e in jloop.hess_eig_l]
    loop.casscf_energy_l = list(jloop.casscf_energy_l)
    loop.act_idx = np.asarray(jloop.act_idx)
    return loop
