"""Parameterized_circuit: the user-facing circuit/RDM interface.

Port of auto_oo_tpu/simulator/circuit.py (reference pqc.py:86-235) on the
direct string-grid route: ``sector=True`` with a built-in ansatz ('ucc',
'np_fabric', 'kupccd'), whose gate program is built straight on the
alpha/beta string lists (simulator/grid_gates.py).  The statevector is
REAL float64: every built-in ansatz is an orthogonal circuit acting on a
real initial state.

The full-space route, prebuilt or callable (custom, possibly complex)
ansatze, ``up_then_down`` ordering and unrestricted RDMs raise
NotImplementedError until later PRs of the port bring them.
"""

import numpy as np
import torch

from ..config import DTYPE, get_device
from ..ops import fermion
from ..ops import grid as _grid
from ..ops import rdms as _rdms
from . import ansatze as A
from . import grid_gates as _gg

_BUILTIN = ("ucc", "np_fabric", "kupccd")


class Parameterized_circuit:
    """Active-space PQC on the sector string grid: state(theta) and RDMs.

    Args mirror the JAX package (reference pqc.py:91-109); ``device``
    places the gate tables, maps and states (default: config's device)."""

    def __init__(self, ncas, nelecas, dev=None, ansatz="ucc", n_layers=3,
                 add_singles=False, interface=None, diff_method=None,
                 k=None, up_then_down=False, sector=False,
                 theta_shape=None, device=None):
        if ansatz not in _BUILTIN:
            raise NotImplementedError(
                "prebuilt GatePrograms and callable ansatze come in a "
                "later PR of the port; use 'ucc', 'np_fabric' or 'kupccd'")
        if not sector:
            raise NotImplementedError(
                "the full-space (sector=False) route comes in a later PR "
                "of the port; pass sector=True")
        if up_then_down:
            raise NotImplementedError(
                "sector circuits fix the interleaved JW ordering; the "
                "up_then_down routes come in a later PR of the port")
        self.ncas = ncas
        self.nelecas = nelecas
        self.n_qubits = 2 * ncas
        self.dev = dev
        self.add_singles = add_singles
        self.interface = "torch"
        self.up_then_down = False
        self.sector = True
        self.ansatz = ansatz
        self.device = get_device(device)

        if ansatz == "ucc":
            self.singles, self.doubles = A.excitations(nelecas,
                                                       self.n_qubits)
            self.theta_shape = (len(self.doubles)
                                + (len(self.singles) if add_singles else 0))
        elif ansatz == "np_fabric":
            self.n_layers = n_layers
            self.full_theta_shape = A.gatefabric_full_shape(
                n_layers, self.n_qubits)
            self.redundant_idx = A.gatefabric_redundant_idx(ncas, nelecas)
            nfull = int(np.prod(self.full_theta_shape))
            self.params_idx = np.array(
                [x for x in range(nfull) if x not in self.redundant_idx])
            self.theta_shape = len(self.params_idx)
        else:
            self.k = k if k is not None else n_layers
            self.d_wires = A.generalized_pair_doubles(
                list(range(self.n_qubits)))
            self.theta_shape = self.k * len(self.d_wires)
        self.hfstate = A.hf_state(nelecas, self.n_qubits)

        self._sector_basis = None
        self.sector_maps = _grid.build_grid_maps(ncas, nelecas,
                                                 device=self.device)
        self.grid_program = _gg.build_direct(
            ncas, nelecas, ansatz, n_layers=n_layers,
            add_singles=add_singles,
            k=(k if k is not None else n_layers), device=self.device)
        # tangent rows of the Jacobian: full program parameter of each
        # entry of theta (np_fabric drops its redundant parameters)
        self._tangent_params = (self.params_idx if ansatz == "np_fabric"
                                else np.arange(self.theta_shape))
        self._tangent_params_dev = torch.as_tensor(
            np.asarray(self._tangent_params, dtype=np.int64),
            device=self.device)

    @property
    def sector_basis(self):
        """The sector's determinant indices, ascending (a host array of D
        int64, built on first use: at (16e,16o) it is 1.3 GB that no
        route of the port reads)."""
        if self._sector_basis is None:
            self._sector_basis = fermion.sector_basis(self.ncas,
                                                      self.nelecas)
        return self._sector_basis

    @property
    def state_dim(self):
        """C(n,na) * C(n,nb), the sector dimension."""
        return self.grid_program.dim

    # -- state ------------------------------------------------------------

    def _as_theta(self, theta):
        return torch.as_tensor(theta, dtype=DTYPE,
                               device=self.device).reshape(-1)

    def _expand_theta(self, theta):
        """theta -> the program's full parameter vector (a differentiable
        scatter; np_fabric's redundant parameters stay 0)."""
        if self.ansatz == "np_fabric":
            nfull = int(np.prod(self.full_theta_shape))
            full = torch.zeros(nfull, dtype=theta.dtype, device=theta.device)
            return full.index_put((self._tangent_params_dev,), theta)
        return theta

    def _state_impl_grid(self, theta):
        """|psi(theta)> in GRID order (ops/grid.py layout contract)."""
        return self.grid_program.apply(self._expand_theta(theta))

    def _state_and_jacobian_grid(self, theta):
        """(psi, J) in GRID order, J = d psi / d theta of shape
        (theta_shape, D), from one tangent-batched forward sweep."""
        return self.grid_program.apply_with_jacobian(
            self._expand_theta(theta), self._tangent_params)

    def _state_hessian_dot_grid(self, theta, w, psi, J):
        """d^2 <w, psi(theta)> / d theta^2 for a GRID-ordered w, given
        (psi, J) at the same theta."""
        return self.grid_program.hessian_dot(
            self._expand_theta(theta), w, psi, J, self._tangent_params)

    def _pair_state_grid(self, theta, v):
        """(|psi(theta)>, J(theta) v) in GRID order from one forward sweep
        carrying the state and one tangent column (the forward of the JAX
        package's ``_pair_state_impl_grid``); ``_expand_theta`` is
        linear, so v expands through it."""
        return self.grid_program.apply_pair(self._expand_theta(theta),
                                            self._expand_theta(v))

    def _pair_row_grid(self, theta, v, a, b, psi=None, delta=None):
        """grad_theta [<psi(theta), a> + <J(theta) v, b>] for GRID-ordered
        a and b from one reverse sweep (the backward of the JAX package's
        ``_pair_state_impl_grid``), given ``(psi, delta) =
        _pair_state_grid(theta, v)`` or computing it."""
        full = self.grid_program.pair_row(
            self._expand_theta(theta), self._expand_theta(v), a, b, psi,
            delta)
        return full[self._tangent_params_dev]

    def _state_impl(self, theta):
        """|psi(theta)> in canonical (sorted determinant) order."""
        return _grid.from_grid(self._state_impl_grid(theta),
                               self.sector_maps)

    def state(self, theta):
        """|psi(theta)> as a real float64 vector over
        ``self.sector_basis`` (canonical ascending-determinant order)."""
        return self._state_impl(self._as_theta(theta))

    def init_zeros(self):
        """All-zero parameter init (reference pqc.py:188)."""
        return torch.zeros(self.theta_shape, dtype=DTYPE, device=self.device)

    # -- RDMs -------------------------------------------------------------

    def _rdms_impl(self, theta):
        # grid order end to end (no boundary permutations)
        psi = self._state_impl_grid(theta)
        return _rdms.rdms_from_state(psi, self.ncas, self.sector_maps,
                                     grid_order=True)

    def get_rdms(self, theta, restricted=True):
        if not restricted:
            raise NotImplementedError(
                "unrestricted RDMs come in a later PR of the port")
        return self._rdms_impl(self._as_theta(theta))

    def get_rdms_from_state(self, state, restricted=True):
        """gamma_pq = <E_pq>, Gamma_pqrs = <e_pqrs> (reference
        pqc.py:192-218) of a canonical-order sector state."""
        if not restricted:
            raise NotImplementedError(
                "unrestricted RDMs come in a later PR of the port")
        state = torch.as_tensor(state, device=self.device)
        if state.shape[-1] != self.state_dim:
            raise ValueError(
                f"state has dim {state.shape[-1]}, but this circuit works "
                f"over the (n_alpha, n_beta) sector basis (dim "
                f"{self.state_dim})")
        return _rdms.rdms_from_state(state, self.ncas, self.sector_maps)
