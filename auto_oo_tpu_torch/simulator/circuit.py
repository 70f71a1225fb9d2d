"""Parameterized_circuit: the user-facing circuit/RDM interface.

Port of auto_oo_tpu/simulator/circuit.py (reference pqc.py:86-235).  Two
routes, as in the JAX package:

* the full space (``sector=False``, the default): a flat GateProgram
  (simulator/program.py) over the 4^ncas basis in canonical order, with
  the flat E_pq maps (ops/rdms.FlatMaps);
* the sector string grid (``sector=True``): a GridGateProgram over the
  (n_alpha, n_beta) sector's (Na, Nb) grid, with GridMaps (ops/grid.py).
  A built-in ansatz ('ucc', 'np_fabric', 'kupccd') is built directly on
  the grid (simulator/grid_gates.py); a prebuilt full-space GateProgram
  is projected onto the sector (simulator/sector.py) and factorized onto
  the grid (grid_program.factorize_program).

``s2_expectation`` / ``sz_value`` are the spin diagnostics: on the grid
through the string-factorized S^- (ops/grid.sminus_grid_maps) straight
from the grid-order state, in the full space through the dense S^2.

``ansatz`` may be a built-in name, a prebuilt GateProgram or any
callable theta -> statevector over the full space, real or complex
(with ``theta_shape=`` or a ``.theta_shape`` attribute; the reference's
arbitrary-QNode capability, pqc.py:163), whose sweeps come from
``torch.func`` over it (simulator/custom.py).  The built-in ansatze and
gate programs give REAL float64 states (orthogonal circuits on a real
start); a callable's state keeps its own dtype, and every RDM and inner
product conjugates the bra side.

``up_then_down=True`` (mode p = spatial p up, p + ncas = spatial p
down) is accepted for a GateProgram or a callable in the full space:
its E_pq maps are the up-then-down ones, and its spin-resolved RDMs come
in that mode order.  The built-in ansatze lay out their qubits
interleaved, and sector mode fixes the interleaved convention (the two
orderings select different determinant sets for one (n_a, n_b)): both
combinations raise ValueError, as in the JAX package; up-then-down RDMs
of a sector state come from ``fermion.reorder_unrestricted_rdms``.
``get_rdms(..., restricted=False)`` / ``get_rdms_from_state(...,
restricted=False)`` give the spin-resolved RDMs over the 2 ncas modes on
every route (ops/rdms.rdms_from_state_unrestricted in the full space,
simulator/sector.rdms_from_sector_state_unrestricted on the grid).
"""

import numpy as np
import torch

from ..config import DTYPE, get_device
from ..ops import fermion
from ..ops import grid as _grid
from ..ops import rdms as _rdms
from . import ansatze as A
from . import grid_gates as _gg
from . import sector as _sector
from .custom import CallableSweep
from .program import GateProgram

_BUILTIN = ("ucc", "np_fabric", "kupccd")


class Parameterized_circuit:
    """Active-space PQC: state(theta) and RDMs.

    Args mirror the JAX package (reference pqc.py:91-109); ``device``
    places the gate tables, maps and states (default: config's device)."""

    def __init__(self, ncas, nelecas, dev=None, ansatz="ucc", n_layers=3,
                 add_singles=False, interface=None, diff_method=None,
                 k=None, up_then_down=False, sector=False,
                 theta_shape=None, device=None):
        builtin = isinstance(ansatz, str) and ansatz in _BUILTIN
        custom = (not builtin and not isinstance(ansatz, GateProgram)
                  and callable(ansatz))
        # the JAX package's constructor rules, in its order
        # (auto_oo_tpu/simulator/circuit.py:45-70, 219-238, 90-94)
        if up_then_down and builtin:
            raise ValueError(
                "built-in ansatze use interleaved ordering; up_then_down "
                "RDMs are supported for custom states / GatePrograms")
        if up_then_down and sector:
            raise ValueError(
                "sector=True fixes the interleaved JW ordering (the "
                "sector basis convention); extract RDMs interleaved and "
                "permute with ops.fermion.reorder_unrestricted_rdms for "
                "up_then_down ordering")
        if not builtin and not custom and not isinstance(ansatz,
                                                          GateProgram):
            raise ValueError(f"unknown ansatz {ansatz!r}")
        if custom:
            if theta_shape is None:
                theta_shape = getattr(ansatz, "theta_shape", None)
            if theta_shape is None:
                raise ValueError(
                    "a callable ansatz needs theta_shape=<n_params> "
                    "(or a .theta_shape attribute on the callable)")
            if sector:
                raise ValueError("sector=True needs a compiled GateProgram")
        self.ncas = ncas
        self.nelecas = nelecas
        self.n_qubits = 2 * ncas
        self.dev = dev
        self.add_singles = add_singles
        self.interface = "torch"
        self.up_then_down = bool(up_then_down)
        self.sector = bool(sector)
        self.ansatz = ansatz
        self.device = get_device(device)
        k = k if k is not None else n_layers

        self.hfstate = A.hf_state(nelecas, self.n_qubits) if builtin \
            else None
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
        elif ansatz == "kupccd":
            self.k = k
            self.d_wires = A.generalized_pair_doubles(
                list(range(self.n_qubits)))
            self.theta_shape = self.k * len(self.d_wires)
        elif custom:
            self.theta_shape = int(np.prod(theta_shape))
        else:
            self.theta_shape = ansatz.n_params

        self._program = None
        self._program_builder = None
        self._sector_basis = None
        self.sector_maps = None
        self.grid_program = None
        if builtin:
            def build():
                dets = self.sector_basis if self.sector else None
                if ansatz == "ucc":
                    return A.uccd_program(ncas, nelecas, add_singles,
                                          dets=dets, device=self.device)
                if ansatz == "np_fabric":
                    return A.gatefabric_program(ncas, nelecas, n_layers,
                                                dets=dets,
                                                device=self.device)
                return A.kupccd_program(ncas, nelecas, k=k, dets=dets,
                                        device=self.device)

            # on the grid the flat program is built only if asked for
            # (draw_circuit): O(n_gates * D) to build, and no route runs it
            self._program_builder = build
        elif not custom:
            if ansatz.device.type != self.device.type:
                raise ValueError(f"the GateProgram's tables are on "
                                 f"{ansatz.device}, the circuit's device "
                                 f"is {self.device}")
            self._program = ansatz
        if self.sector:
            if builtin:
                self.grid_program = _gg.build_direct(
                    ncas, nelecas, ansatz, n_layers=n_layers,
                    add_singles=add_singles, k=k, device=self.device)
            else:
                from . import grid_program as _gp
                if ansatz.dim == 1 << self.n_qubits:
                    self._program, self._sector_basis = \
                        _sector.project_program(ansatz, ncas, nelecas)
                elif ansatz.dim != len(self.sector_basis):
                    raise ValueError(
                        f"a sector circuit needs a program over 4^{ncas} "
                        f"states or the sector's {len(self.sector_basis)}, "
                        f"got dim {ansatz.dim}")
                self.grid_program = _gp.factorize_program(
                    self.program, self.sector_basis, ncas)
            self.sector_maps = _grid.build_grid_maps(ncas, nelecas,
                                                     device=self.device)
            self.epq_maps = self.sector_maps
            self._sweep = self.grid_program
        else:
            if custom:
                self._sweep = CallableSweep(ansatz, 1 << self.n_qubits)
            elif self.program.dim != 1 << self.n_qubits:
                raise ValueError(
                    f"a full-space circuit needs a program over 4^{ncas} "
                    f"states, got dim {self.program.dim}")
            else:
                self._sweep = self.program
            self.epq_maps = _rdms.build_flat_maps(ncas, self.up_then_down,
                                                  device=self.device)
        # tangent rows of the Jacobian: full program parameter of each
        # entry of theta (np_fabric drops its redundant parameters)
        self._tangent_params = (self.params_idx if ansatz == "np_fabric"
                                else np.arange(self.theta_shape))
        self._tangent_params_dev = torch.as_tensor(
            np.asarray(self._tangent_params, dtype=np.int64),
            device=self.device)

    @property
    def program(self):
        """The flat GateProgram: the full-space circuit, or in sector mode
        the sector-rank one (built on first use for a built-in ansatz,
        whose grid program serves every route); None for a callable."""
        if self._program is None and self._program_builder is not None:
            self._program = self._program_builder()
            self._program_builder = None
        return self._program

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
        """C(n,na) * C(n,nb) in sector mode, else 4^ncas."""
        return self._sweep.dim

    # -- state ------------------------------------------------------------

    def _as_theta(self, theta):
        return torch.as_tensor(theta, dtype=DTYPE,
                               device=self.device).reshape(-1)

    def _expand_theta(self, theta):
        """theta -> the program's full parameter vector (a differentiable
        scatter; np_fabric's redundant parameters stay 0); a (B, n) stack
        gives (B, n_full)."""
        if self.ansatz == "np_fabric":
            nfull = int(np.prod(self.full_theta_shape))
            if theta.dim() > 1:
                full = theta.new_zeros(theta.shape[:-1] + (nfull,))
                return full.index_copy(-1, self._tangent_params_dev, theta)
            full = torch.zeros(nfull, dtype=theta.dtype, device=theta.device)
            return full.index_put((self._tangent_params_dev,), theta)
        return theta

    # The ``_grid`` methods give states in the order of the route's maps
    # (``epq_maps``): GRID order (ops/grid.py) in sector mode, the
    # canonical basis order in the full space.

    def _state_impl_grid(self, theta):
        """|psi(theta)> in the maps' order."""
        return self._sweep.apply(self._expand_theta(theta))

    def _state_and_jacobian_grid(self, theta):
        """(psi, J) in the maps' order, J = d psi / d theta of shape
        (theta_shape, D), from one tangent-batched forward sweep."""
        return self._sweep.apply_with_jacobian(
            self._expand_theta(theta), self._tangent_params)

    def _state_hessian_dot_grid(self, theta, w, psi, J):
        """d^2 <w, psi(theta)> / d theta^2 for w in the maps' order,
        given (psi, J) at the same theta."""
        return self._sweep.hessian_dot(
            self._expand_theta(theta), w, psi, J, self._tangent_params)

    def _pair_state_grid(self, theta, v):
        """(|psi(theta)>, J(theta) v) in the maps' order from one forward
        sweep carrying the state and one tangent column (the forward of
        the JAX package's ``_pair_state_impl_grid``); ``_expand_theta``
        is linear, so v expands through it."""
        return self._sweep.apply_pair(self._expand_theta(theta),
                                      self._expand_theta(v))

    def _pair_row_grid(self, theta, v, a, b, psi=None, delta=None):
        """grad_theta [<psi(theta), a> + <J(theta) v, b>] for a and b in
        the maps' order from one reverse sweep (the backward of the JAX
        package's ``_pair_state_impl_grid``), given ``(psi, delta) =
        _pair_state_grid(theta, v)`` or computing it.  With v = 0 and b =
        0 it is the adjoint gradient of <psi(theta), a>."""
        full = self._sweep.pair_row(
            self._expand_theta(theta), self._expand_theta(v), a, b, psi,
            delta)
        return full[self._tangent_params_dev]

    def _state_impl(self, theta):
        """|psi(theta)> in canonical (sorted determinant) order."""
        psi = self._state_impl_grid(theta)
        if self.sector:
            return _grid.from_grid(psi, self.sector_maps)
        return psi

    def state(self, theta):
        """|psi(theta)>: dim 4^ncas in the full space, or over
        ``self.sector_basis`` (canonical ascending-determinant order) when
        sector=True; real float64, or a callable's own dtype."""
        return self._state_impl(self._as_theta(theta))

    def state_complex(self, theta):
        return self.state(theta).to(torch.complex128)

    def qnode(self, theta):
        """Reference-compatible alias (pqc.py:133)."""
        return self.state(theta)

    def init_zeros(self):
        """All-zero parameter init (reference pqc.py:188)."""
        return torch.zeros(self.theta_shape, dtype=DTYPE, device=self.device)

    # -- RDMs -------------------------------------------------------------

    def _rdms_impl(self, theta):
        # the maps' order end to end (no boundary permutations)
        psi = self._state_impl_grid(theta)
        return _rdms.rdms_from_state(psi, self.ncas, self.epq_maps,
                                     grid_order=True)

    def _umaps(self):
        """The sector's cross-sector pair-annihilation maps for the
        spin-resolved RDMs (simulator/sector.py), built on first use."""
        if not hasattr(self, "_sector_umaps"):
            self._sector_umaps = _sector.sector_pair_annihilation_maps(
                self.ncas, self.nelecas, device=self.device)
        return self._sector_umaps

    def _rdms_unrestricted(self, psi):
        """Spin-resolved RDMs of a canonical-order state."""
        if self.sector:
            return _sector.rdms_from_sector_state_unrestricted(
                psi, self.sector_maps, self._umaps(), self.ncas)
        return _rdms.rdms_from_state_unrestricted(psi, self.ncas)

    def get_rdms(self, theta, restricted=True):
        """(gamma, Gamma) at theta: spin-summed restricted RDMs, or with
        ``restricted=False`` the spin-resolved ones over 2 ncas modes
        (gamma_pq = <a^dag_p a_q>, Gamma_pqrs = <a^dag_p a^dag_q a_r
        a_s>)."""
        if not restricted:
            return self._rdms_unrestricted(
                self._state_impl(self._as_theta(theta)))
        return self._rdms_impl(self._as_theta(theta))

    def get_rdms_from_state(self, state, restricted=True):
        """gamma_pq = <E_pq>, Gamma_pqrs = <e_pqrs> (reference
        pqc.py:192-218) of a canonical-order state, real or complex (the
        bra side is conjugated and the real part taken): over the full
        4^ncas space, or over the sector basis when sector=True.
        ``restricted=False`` gives the spin-resolved RDMs over 2 ncas
        modes (reference pqc.py:192-218 with restricted=False)."""
        state = torch.as_tensor(state, device=self.device)
        if state.shape[-1] != self.state_dim:
            where = ("the (n_alpha, n_beta) sector basis" if self.sector
                     else f"the full 4^{self.ncas} space")
            raise ValueError(
                f"state has dim {state.shape[-1]}, but this circuit works "
                f"over {where} (dim {self.state_dim})")
        if not restricted:
            return self._rdms_unrestricted(state)
        return _rdms.rdms_from_state(state, self.ncas, self.epq_maps)

    # -- spin diagnostics -------------------------------------------------

    def _s2maps(self):
        """The grid S^- maps of the sector (built on first use; None where
        S^- is the zero map)."""
        if not hasattr(self, "_sector_s2maps"):
            self._sector_s2maps = _grid.sminus_grid_maps(
                self.ncas, self.nelecas, device=self.device)
        return self._sector_s2maps

    def s2_expectation(self, theta):
        """<psi(theta)|S^2|psi(theta)>, the spin-purity diagnostic
        (reference utils/active_space.py:243-253 via a dense matrix).  On a
        sector: ||S^- psi||^2 + Sz^2 - Sz from the grid-order state, with
        no D-sized permutation and no 4^ncas operator; in the full space:
        the dense S^2 quadratic form."""
        theta = self._as_theta(theta)
        if self.sector:
            maps = self.sector_maps
            return _grid.s2_expectation_grid(
                self._state_impl_grid(theta).reshape(maps.Na, maps.Nb),
                maps, self._s2maps(), self.nelecas)
        return self.s2_expectation_of_state(self._state_impl(theta))

    def s2_expectation_of_state(self, state):
        """<S^2> of an explicit canonical-order state: over the sector basis
        when sector=True, else over the full 4^ncas space."""
        state = torch.as_tensor(state, device=self.device)
        if self.sector:
            return _grid.s2_expectation_grid(state, self.sector_maps,
                                             self._s2maps(), self.nelecas)
        s2 = _rdms.s2_matrix(self.ncas, self.device).to(state.dtype)
        return torch.linalg.vecdot(state, s2 @ state).real

    def sz_value(self):
        """Exact S_z of the simulated sector, (n_a - n_b)/2."""
        na, nb = _grid._nelec_split(self.nelecas)
        return 0.5 * (na - nb)

    # -- misc -------------------------------------------------------------

    def draw_circuit(self, theta):
        """Wire-diagram rendering of the flat program, in the style of
        qml.draw (reference pqc.py:223): one row per qubit, one column per
        gate, multi-wire gates joined by box connectors.  Falls back to a
        flat gate table when the program carries no display metadata."""
        prog = self.program
        if prog is None:
            return "<custom state function>"
        full = self._expand_theta(self._as_theta(theta)).cpu().numpy()
        meta = prog.gate_meta
        header = (f"GateProgram: {prog.half.shape[0]} pair-rotation gates, "
                  f"{prog.n_params} parameters, dim {prog.dim}")
        if not meta or any(m[0] is None for m in meta):
            lines = [header]
            for i in range(prog.half.shape[0]):
                ang = prog.half[i] * full[prog.param[i]]
                lines.append(
                    f"  gate {i:3d}: param {prog.param[i]:3d} "
                    f"angle {ang:+.4f} pairs {int(prog.n_real_pairs[i])}")
            return "\n".join(lines)

        abbrev = {"FermionicDouble": "G2", "FermionicSingle": "G1",
                  "DoubleExcitation": "G2", "SingleExcitation": "G",
                  "OrbitalRotation": "OR"}
        # merge consecutive PairGates sharing (name, wires, param) — e.g.
        # OrbitalRotation compiles to two pair gates with one parameter
        merged = []
        for name, wires, param in meta:
            if merged and merged[-1] == (name, wires, param):
                continue
            merged.append((name, wires, param))
        nq = self.n_qubits
        rows = [[] for _ in range(nq)]
        for name, wires, param in merged:
            label = f"{abbrev.get(name, name)}({full[param]:+.2f})"
            lo, hi = min(wires), max(wires)
            width = len(label) + 1
            for q in range(nq):
                if q in wires:
                    conn = ("╭" if q == lo else
                            "╰" if q == hi else "├")
                    cell = conn + label
                elif lo < q < hi:
                    cell = "│"
                else:
                    cell = ""
                rows[q].append(cell.ljust(width, "─"))
        out = [header]
        for q in range(nq):
            out.append(f"q{q:02d}: ─" + "─".join(rows[q]) + "─")
        return "\n".join(out)


def dirac_notation(state, decimals=2, atol=1e-8):
    """Pretty-print a statevector as a Dirac-notation sum (the
    cirq.dirac_notation capability the reference tutorials use).  Qubit 0
    is the leftmost bit label, matching the simulator's layout."""
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    state = np.asarray(state).ravel()
    nq = int(round(np.log2(state.size)))
    if 1 << nq != state.size:
        raise ValueError(f"statevector length {state.size} is not 2^n")
    terms = []
    for idx in np.flatnonzero(np.abs(state) > atol):
        amp = state[idx]
        label = format(idx, f"0{nq}b")
        if abs(np.imag(amp)) < atol:
            a = float(np.real(amp))
            mag = f"{abs(a):.{decimals}f}"
            sign = "-" if a < 0 else "+"
        else:
            mag = (f"({np.real(amp):.{decimals}f}"
                   f"{np.imag(amp):+.{decimals}f}j)")
            sign = "+"
        if not terms and sign == "+":
            terms.append(f"{mag}|{label}⟩")
        else:
            terms.append(f"{sign} {mag}|{label}⟩" if terms
                         else f"-{mag}|{label}⟩")
    return " ".join(terms) if terms else "0"
