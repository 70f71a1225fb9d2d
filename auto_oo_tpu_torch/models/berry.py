"""Berry-phase / conical-intersection workflow.

Port of auto_oo_tpu/models/berry.py (the reference's
examples/Tutorial_Berry_phase.ipynb as a library API): (1) a full OO-VQE
optimization at the first loop geometry, (2) damped-Newton tracking at
each further geometry, warm-started from the previous (theta,
oao_mo_coeff), (3) the transfer of each state into the next geometry's
orbital basis by the number-conserving Thouless rotation
G = Gamma(M) = exp{sum [log M]_pq E_pq} of the active-block MO overlap M,
(4) Berry phase = arg of the product of successive overlaps
<psi_{i+1}|G|psi_i>.

The transfer runs on the circuit's device through the port's flat gate
programs: M is split on the host into M = W' Dw V' diag(sigma) V'^T (a
polar split, W' and V' special-orthogonal, Dw a sign flip), the two
orthogonal factors are Givens-decomposed into the fermionic
single-excitation pair gates the ansatze use (``gates.fermionic_single_
pairs``, ``ansatze._finalize_program``), and diag(sigma) acts as an
occupation-weighted diagonal.  The gates conserve the particle sector,
so a sector circuit transfers in its own canonical basis (``dets``).
The scipy ``expm_multiply`` route over the 4^ncas space is kept as the
host oracle, ``transfer_state_host``.

``BerryPhaseLoop.run`` tracks with ``OO_pqc._nr_iteration``, the port's
one damped-Newton iteration; ``run_batched`` tracks every further
geometry at once, in lockstep, through ``parallel.GeometryBatch``.
"""

import numpy as np
import torch
from scipy import sparse
from scipy.linalg import logm
from scipy.sparse.linalg import expm_multiply

from ..config import DTYPE
from ..moldata import Moldata
from ..ops import fermion
from ..simulator import gates as G
from ..simulator.ansatze import _finalize_program
from ..utils.misc import to_numpy
from .oo_pqc import OO_pqc

# the damped-Newton parameters of the tracking step: alpha, beta, mu, rho,
# lambda_min (the JAX package's _nr_iteration_jit call)
_TRACK_STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)


def _active_block(mo_atob, act_idx):
    """M = (C_a^T C_b)^T restricted to the active orbitals."""
    act = np.asarray(act_idx, dtype=int)
    return to_numpy(mo_atob).T[np.ix_(act, act)]


def orbital_rotation_generator(M_act, ncas):
    """Sparse one-body generator sum_pq [log M]_pq E_pq over the
    2^(2 ncas) space (spin-summed, interleaved ordering)."""
    K = logm(np.asarray(M_act))
    D = 1 << (2 * ncas)
    gen = sparse.csr_matrix((D, D), dtype=complex)
    for p in range(ncas):
        for q in range(ncas):
            if abs(K[p, q]) > 1e-14:
                gen = gen + K[p, q] * fermion.epq_sparse(p, q, ncas).astype(
                    complex)
    return gen


def transfer_state_host(state, mo_atob, act_idx, ncas):
    """Host oracle of ``transfer_state``: expm-multiply of the sparse
    one-body generator over the full 4^ncas space (complex numpy)."""
    gen = orbital_rotation_generator(_active_block(mo_atob, act_idx), ncas)
    return expm_multiply(gen, to_numpy(state).astype(complex))


def givens_angles(R, tol=1e-12):
    """Decompose R in SO(n) into plane rotations: R = rot(i1,j1,t1) @ ...
    @ rot(ik,jk,tk), where rot(i,j,t) has [i,i] = [j,j] = cos t, [i,j] =
    sin t, [j,i] = -sin t (the one-body matrix of exp(t (a^dag_i a_j -
    a^dag_j a_i))).  Host-side, O(n^3)."""
    A = np.asarray(R, dtype=float).copy()
    n = A.shape[0]
    left = []  # rotations L_k with L_m ... L_1 R = I
    for j in range(n - 1):
        for i in range(n - 1, j, -1):
            b = A[i, j]
            a = A[i - 1, j]
            # rotate where there is a sub-entry to zero OR the upper entry
            # is negative (a pi rotation repairs the -1 diagonal pairs a
            # reflection leaves)
            if abs(b) < tol and a >= -tol:
                continue
            t = np.arctan2(b, a)
            A = _rot(n, i - 1, i, t) @ A
            left.append((i - 1, i, t))
    assert np.allclose(A, np.eye(n), atol=1e-9), \
        "givens_angles expects a special-orthogonal matrix"
    # R = L_1^{-1} ... L_m^{-1}, and rot(i, j, t)^{-1} = rot(i, j, -t)
    return [(i, j, -t) for (i, j, t) in left]


def _rot(n, i, j, t):
    R = np.eye(n)
    c, s = np.cos(t), np.sin(t)
    R[i, i] = c
    R[j, j] = c
    R[i, j] = s
    R[j, i] = -s
    return R


def transfer_factors(M):
    """Host factorization of Gamma(M) for any invertible real M:
    M = W' Dw V' diag(sigma) V'^T with W', V' special-orthogonal and
    Dw = diag(1..1, det-sign).  Returns (rots_W, flip_W, rots_V, sigma),
    rots_* as ``givens_angles`` lists."""
    M = np.asarray(M, dtype=float)
    U, sigma, Vt = np.linalg.svd(M)
    W = U @ Vt
    V = Vt.T
    flip_W = bool(np.linalg.det(W) < 0)
    if flip_W:
        W = W.copy()
        W[:, -1] *= -1.0
    if np.linalg.det(V) < 0:
        # flipping one column of V leaves V diag(s) V^T unchanged
        V = V.copy()
        V[:, -1] *= -1.0
    return givens_angles(W), flip_W, givens_angles(V), sigma


def _rotation_program(rots, ncas, dets=None, transpose=False, device=None):
    """(GateProgram, angles) applying Gamma(prod_k rot(i_k, j_k, t_k)): one
    fermionic single-excitation pair gate per spin per rotation, the
    rightmost factor first, on ``device``."""
    nm = 2 * ncas
    seq = list(rots)
    if transpose:  # Gamma(R^T): reversed factors, negated angles
        seq = [(i, j, -t) for (i, j, t) in reversed(seq)]
    # Gamma(G1 G2 ...)|psi> applies the RIGHTMOST factor first; the gate
    # program applies list order first
    seq = list(reversed(seq))
    gate_list = [G.fermionic_single_pairs(2 * i + s, 2 * j + s, nm, param=k,
                                          half=1.0, dets=dets)
                 for k, (i, j, _) in enumerate(seq) for s in (0, 1)]
    init = (fermion.hf_bitstring(ncas, 0)[0] if dets is None
            else int(np.asarray(dets)[0]))
    prog = _finalize_program(gate_list, max(len(seq), 1), init, nm, dets,
                             device)
    angles = [t for (_, _, t) in seq] or [0.0]
    return prog, torch.tensor(angles, dtype=DTYPE, device=prog.device)


def _occupation_matrix(ncas, dets=None):
    """occ[d, p] = occupation (0/1/2) of spatial orbital p in basis
    determinant d (interleaved ordering)."""
    nm = 2 * ncas
    dets = (np.arange(1 << nm, dtype=np.int64) if dets is None
            else np.asarray(dets, dtype=np.int64))
    occ = np.zeros((len(dets), ncas), dtype=np.int8)
    for p in range(ncas):
        occ[:, p] = (fermion.occ_bit(dets, 2 * p, nm)
                     + fermion.occ_bit(dets, 2 * p + 1, nm))
    return occ


def transfer_state(state, mo_atob, act_idx, ncas, dets=None, device=None):
    """Transfer a statevector between active-orbital bases on the device.

    ``mo_atob``: the OAO-MO overlap C_a^T C_b of consecutive geometries;
    its transposed active block M defines the Thouless rotation (notebook
    cell 28).  Gamma(M) is applied as Givens-gate programs and one
    occupation weighting, exact for any invertible real M (reflections
    and non-orthogonal M included).  ``dets`` runs the transfer in a
    sector basis (pass ``pqc.sector_basis``).  Returns a tensor on
    ``device`` (by default the state's, for a tensor state)."""
    if device is None and isinstance(state, torch.Tensor):
        device = state.device
    rots_W, flip_W, rots_V, sigma = transfer_factors(
        _active_block(mo_atob, act_idx))
    occ = _occupation_matrix(ncas, dets)
    prog_vt, ang_vt = _rotation_program(rots_V, ncas, dets, transpose=True,
                                        device=device)
    if not isinstance(state, torch.Tensor):
        state = np.asarray(state)
    psi = torch.as_tensor(state, dtype=DTYPE, device=prog_vt.device)
    # Gamma(M) = Gamma(W') Gamma(Dw) Gamma(V') Gamma(diag sigma) Gamma(V'^T)
    psi = prog_vt.apply(ang_vt, psi)
    occ_dev = torch.as_tensor(occ, dtype=DTYPE, device=psi.device)
    log_sigma = torch.as_tensor(np.log(sigma), dtype=DTYPE,
                                device=psi.device)
    psi = psi * torch.exp(occ_dev @ log_sigma)
    prog_v, ang_v = _rotation_program(rots_V, ncas, dets, device=device)
    psi = prog_v.apply(ang_v, psi)
    if flip_W:
        # Gamma(diag(1..1, -1)) multiplies by (-1)^{n_last}
        psi = psi * (1.0 - 2.0 * (occ_dev[:, -1] % 2))
    prog_w, ang_w = _rotation_program(rots_W, ncas, dets, device=device)
    return prog_w.apply(ang_w, psi)


class BerryPhaseLoop:
    """Adiabatic tracking of an OO-VQE state around a geometry loop.

    Args:
        geometries: geometry strings around the loop (first and last
            should coincide for an exact final overlap).
        basis, ncas, nelecas: the problem.
        pqc: a Parameterized_circuit shared across geometries; every
            OO_pqc of the loop runs on its device.
        freeze_active: freeze the active-active rotations (as the
            tutorial does).
        run_casscf: also run the host CASSCF oracle at each point.
        newton_method: the Newton solve of every OO_pqc (None / "eigh" or
            "iterative"; ``hess_eig_l``, the lowest Hessian eigenvalue
            tracked as the conical-intersection diagnostic, is exact with
            eigh and within ~1% on clustered spectra with "iterative").
        newton_kwargs: passed to the first point's ``full_optimization``.
    """

    def __init__(self, geometries, basis, ncas, nelecas, pqc,
                 freeze_active=True, run_casscf=False, newton_method=None,
                 **newton_kwargs):
        self.geometries = list(geometries)
        self.basis = basis
        self.ncas = ncas
        self.nelecas = nelecas
        self.pqc = pqc
        self.freeze_active = freeze_active
        self.run_casscf = run_casscf
        self.newton_method = newton_method
        self.newton_kwargs = newton_kwargs
        self.theta_l = []
        self.oao_mo_coeff_l = []
        self.energy_l = []
        self.hess_eig_l = []
        self.casscf_energy_l = []
        self.act_idx = None

    def _oo(self, mol, oao=None):
        return OO_pqc(self.pqc, mol, self.ncas, self.nelecas,
                      oao_mo_coeff=oao, freeze_active=self.freeze_active,
                      newton_method=self.newton_method)

    def _casscf(self, mol):
        if self.run_casscf:
            mol.run_casscf(self.ncas, self.nelecas)
            self.casscf_energy_l.append(mol.casscf.e_tot)

    def run(self, theta_init=None, conv_tol=1e-10, max_iterations=50,
            track_steps=1, track_tol=None, verbose=0):
        """Full optimization at point 0, then adiabatic tracking at each
        further point (notebook cells 19-22): up to ``track_steps``
        damped-Newton iterations per point (the reference notebook took
        one), stopping early once |dE| < ``track_tol`` where given."""
        mol0 = Moldata(self.geometries[0], self.basis)
        oo0 = self._oo(mol0)
        self.act_idx = oo0.act_idx
        theta0 = (self.pqc.init_zeros() if theta_init is None
                  else torch.as_tensor(theta_init, dtype=DTYPE,
                                       device=self.pqc.device))
        energy_l, theta_l, _, oao_l, hess_eig_l = oo0.full_optimization(
            theta0, max_iterations=max_iterations, conv_tol=conv_tol,
            verbose=verbose, **self.newton_kwargs)
        theta, oao = theta_l[-1], oao_l[-1]
        self.theta_l = [theta]
        self.oao_mo_coeff_l = [oao]
        self.energy_l = [energy_l[-1]]
        self.hess_eig_l = [hess_eig_l[-1]]
        self.casscf_energy_l = []
        self._casscf(mol0)

        for step, geo in enumerate(self.geometries[1:], start=1):
            mol = Moldata(geo, self.basis)
            oo = self._oo(mol, oao)
            energy_prev = None
            for _ in range(max(1, int(track_steps))):
                theta, _, oao, energy, hess_eig = oo._nr_iteration(
                    theta, oao, *_TRACK_STEP)
                energy = float(energy)
                if (track_tol is not None and energy_prev is not None
                        and abs(energy - energy_prev) < track_tol):
                    break
                energy_prev = energy
            self.theta_l.append(theta)
            self.oao_mo_coeff_l.append(oao)
            self.energy_l.append(energy)
            self.hess_eig_l.append(float(hess_eig))
            self._casscf(mol)
            if verbose:
                print(f"Energy at step {step}: {energy:.10f}")
        return self

    def run_batched(self, theta_init=None, conv_tol=1e-10,
                    max_iterations=50, track_steps=4, verbose=0, mesh=None):
        """Adiabatic tracking with all loop geometries advancing together
        (the JAX package's run_batched, auto_oo_tpu/models/berry.py:
        303-363): a full optimization at point 0, then every further
        geometry warm-starts from the point-0 solution and takes
        ``track_steps`` batched damped-Newton steps in lockstep
        (``GeometryBatch.optimize``), the geometries as lanes of one
        batched step.  Unlike ``run`` (each geometry from its
        predecessor, one step each), every geometry starts from point 0,
        so a dense loop needs a few more steps per geometry, all of them
        run at once.  ``mesh`` is GeometryBatch's: a DeviceMesh whose
        "dp" ranks split the tracked geometries."""
        from ..parallel.sharding import GeometryBatch

        mol0 = Moldata(self.geometries[0], self.basis)
        oo0 = self._oo(mol0)
        self.act_idx = oo0.act_idx
        theta0 = (self.pqc.init_zeros() if theta_init is None
                  else torch.as_tensor(theta_init, dtype=DTYPE,
                                       device=self.pqc.device))
        energy_l, theta_l, _, oao_l, hess_eig_l = oo0.full_optimization(
            theta0, max_iterations=max_iterations, conv_tol=conv_tol,
            verbose=verbose, **self.newton_kwargs)
        theta, oao = theta_l[-1], oao_l[-1]
        self.theta_l = [theta]
        self.oao_mo_coeff_l = [oao]
        self.energy_l = [energy_l[-1]]
        self.hess_eig_l = [hess_eig_l[-1]]
        self.casscf_energy_l = []
        self._casscf(mol0)

        mols = [Moldata(g, self.basis) for g in self.geometries[1:]]
        batch = GeometryBatch(mols, self.ncas, self.nelecas, self.pqc,
                              mesh=mesh, freeze_active=self.freeze_active)
        hist, thetas, oaos, lowests = batch.optimize(
            theta, oao_mo0=oao, n_steps=max(1, int(track_steps)))
        energies, lowest_l = hist[-1].tolist(), lowests.tolist()
        for i, mol in enumerate(mols):
            self.theta_l.append(thetas[i])
            self.oao_mo_coeff_l.append(oaos[i])
            self.energy_l.append(energies[i])
            self.hess_eig_l.append(lowest_l[i])
            self._casscf(mol)
        if verbose:
            print("batched tracking energies:",
                  [f"{e:.8f}" for e in self.energy_l[1:]])
        return self

    def states(self):
        """Circuit statevectors along the loop, in canonical order
        (notebook cell 25)."""
        return [self.pqc.state(th) for th in self.theta_l]

    def overlaps(self):
        """Successive overlaps <psi_{i+1}| G_{i->i+1} |psi_i> (notebook
        cells 30-32) as a complex numpy array; the transfer runs on the
        circuit's device, in the sector basis for a sector circuit."""
        states = self.states()
        dets = self.pqc.sector_basis if self.pqc.sector else None
        oao = [to_numpy(c) for c in self.oao_mo_coeff_l]
        n = len(states)
        out = []
        for i in range(n):
            j = (i + 1) % n
            moved = transfer_state(states[i], oao[i].T @ oao[j],
                                   self.act_idx, self.ncas, dets=dets)
            out.append(complex(float(states[j] @ moved)))
        return np.array(out)

    def berry_phase(self):
        """arg of the product of the loop's overlaps; ~pi around a conical
        intersection (notebook cell 33)."""
        return float(np.angle(np.prod(self.overlaps())))
