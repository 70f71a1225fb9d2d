"""Plain NumPy chemistry of a hydrogen chain in STO-3G: integrals and RHF.

Every function of a hydrogen atom's STO-3G basis is one contracted 1s
Gaussian (Hehre, Stewart and Pople, J. Chem. Phys. 51, 2657 (1969): the
universal 1s fit at zeta = 1, scaled by zeta_H^2 = 1.24^2), so every
integral is the closed form of s-type Gaussians (Szabo and Ostlund,
Modern Quantum Chemistry, appendix A) with the Boys function F0.  The
RHF is a plain DIIS SCF.  The molecular orbitals carry one fixed sign
convention (``fix_signs``), so that circuit angles mean the same thing
on every machine.
"""

import numpy as np
from scipy.special import erf

#: Angstrom per Bohr (CODATA 2010, the value PySCF uses)
BOHR = 0.52917721092
#: STO-3G universal 1s fit at zeta = 1 (Hehre, Stewart and Pople 1969)
EXP_1S = np.array([2.227660584, 0.405771156, 0.109817510])
COEF_1S = np.array([0.154328967, 0.535328142, 0.444634542])
ZETA_H = 1.24


def chain_geometry(n_atoms, spacing):
    """The geometry string of a linear chain of ``n_atoms`` hydrogens
    along z, ``spacing`` Angstrom apart; each coordinate printed to ten
    decimals, so both sides parse the same numbers."""
    return "; ".join(f"H 0 0 {i * spacing:.10f}" for i in range(n_atoms))


def parse_chain(geometry):
    """(charges, coordinates in Bohr) of a geometry string of hydrogens."""
    coords = []
    for atom in geometry.split(";"):
        sym, *xyz = atom.split()
        if sym.upper() != "H":
            raise ValueError(f"a hydrogen chain holds H atoms, not {sym}")
        coords.append([float(v) for v in xyz])
    coords = np.array(coords) / BOHR
    return np.ones(len(coords)), coords


def _boys0(t):
    """F0(t) = 1/2 sqrt(pi/t) erf(sqrt(t)), with its series near 0."""
    t = np.asarray(t, dtype=np.float64)
    small = t < 1e-12
    ts = np.where(small, 1.0, t)
    return np.where(small, 1.0 - t / 3.0,
                    0.5 * np.sqrt(np.pi / ts) * erf(np.sqrt(ts)))


def integrals(geometry):
    """(S, T + V, (pq|rs), E_nuc) of the chain in its STO-3G basis, one
    normalized contracted 1s function per atom, chemists' notation."""
    charges, R = parse_chain(geometry)
    a = EXP_1S * ZETA_H ** 2
    d = COEF_1S * (2.0 * a / np.pi) ** 0.75
    n = len(R)
    # primitive pairs (atom i, prim k) x (atom j, prim l)
    ai, aj = a[:, None], a[None, :]
    p = ai + aj                                   # (3, 3)
    mu = ai * aj / p
    R2 = ((R[:, None, :] - R[None, :, :]) ** 2).sum(-1)          # (n, n)
    Kab = np.exp(-mu[None, None] * R2[:, :, None, None])         # (n,n,3,3)
    dd = d[:, None] * d[None, :]
    s_prim = (np.pi / p) ** 1.5 * Kab
    S = np.einsum("kl,ijkl->ij", dd, s_prim)
    T = np.einsum("kl,ijkl->ij", dd,
                  mu * (3.0 - 2.0 * mu * R2[:, :, None, None]) * s_prim)
    # Gaussian product centres P (n, n, 3, 3, xyz)
    P = ((ai[None, None, :, :, None] * R[:, None, None, None, :]
          + aj[None, None, :, :, None] * R[None, :, None, None, :])
         / p[None, None, :, :, None])
    V = np.zeros((n, n))
    for c in range(n):
        t = p * ((P - R[c]) ** 2).sum(-1)
        V -= charges[c] * np.einsum(
            "kl,ijkl->ij", dd, 2.0 * np.pi / p * Kab * _boys0(t))
    # (ij|kl) over primitive quadruples
    pre = (dd[None, None] * Kab)                                 # (n,n,3,3)
    eri = np.zeros((n, n, n, n))
    for k1 in range(3):
        for l1 in range(3):
            p1 = p[k1, l1]
            P1 = P[:, :, k1, l1]                                  # (n,n,3)
            w1 = pre[:, :, k1, l1]
            for k2 in range(3):
                for l2 in range(3):
                    p2 = p[k2, l2]
                    P2 = P[:, :, k2, l2]
                    w2 = pre[:, :, k2, l2]
                    PQ2 = ((P1[:, :, None, None, :] - P2[None, None])
                           ** 2).sum(-1)
                    eri += (w1[:, :, None, None] * w2[None, None]
                            * 2.0 * np.pi ** 2.5
                            / (p1 * p2 * np.sqrt(p1 + p2))
                            * _boys0(p1 * p2 / (p1 + p2) * PQ2))
    # normalize the contracted functions
    norm = 1.0 / np.sqrt(np.diag(S))
    S = S * norm[:, None] * norm[None, :]
    hcore = (T + V) * norm[:, None] * norm[None, :]
    eri = np.einsum("ijkl,i,j,k,l->ijkl", eri, norm, norm, norm, norm)
    diff = R[:, None, :] - R[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    iu = np.triu_indices(n, 1)
    e_nuc = float((charges[:, None] * charges[None, :])[iu].dot(
        1.0 / dist[iu]))
    return S, hcore, eri, e_nuc


def rhf(S, hcore, eri, n_elec, conv=1e-12, max_cycle=300, diis=8):
    """Closed-shell SCF with DIIS on FDS - SDF.  Returns (E_elec, C,
    orbital energies); raises if it does not converge."""
    nocc = n_elec // 2
    w, v = np.linalg.eigh(S)
    X = v @ np.diag(w ** -0.5) @ v.T

    def solve(F):
        e, cp = np.linalg.eigh(X.T @ F @ X)
        C = X @ cp
        return e, C, 2.0 * C[:, :nocc] @ C[:, :nocc].T

    e, C, D = solve(hcore)
    errs, focks, e_old = [], [], 0.0
    for _ in range(max_cycle):
        F = (hcore + np.einsum("pqrs,rs->pq", eri, D)
             - 0.5 * np.einsum("prqs,rs->pq", eri, D))
        e_elec = 0.5 * float(np.sum(D * (hcore + F)))
        err = X.T @ (F @ D @ S - S @ D @ F) @ X
        if abs(e_elec - e_old) < conv and np.abs(err).max() < 1e-10:
            return e_elec, C, e
        e_old = e_elec
        errs.append(err)
        focks.append(F)
        errs, focks = errs[-diis:], focks[-diis:]
        if len(errs) > 1:
            m = len(errs)
            B = -np.ones((m + 1, m + 1))
            B[m, m] = 0.0
            B[:m, :m] = [[np.vdot(x, y) for y in errs] for x in errs]
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            c = np.linalg.solve(B, rhs)[:m]
            F = sum(ci * Fi for ci, Fi in zip(c, focks))
        e, C, D = solve(F)
    raise RuntimeError("RHF did not converge")


def fix_signs(C):
    """Each column of C with its first entry above a thousandth of the
    column's largest made positive: orbitals are defined up to a sign,
    and circuit angles only mean one thing under one convention."""
    C = np.array(C, dtype=np.float64, copy=True)
    for j in range(C.shape[1]):
        col = C[:, j]
        first = np.flatnonzero(np.abs(col) > 1e-3 * np.abs(col).max())[0]
        if col[first] < 0:
            C[:, j] = -col
    return C


def mo_hamiltonian(geometry, n_elec):
    """(E_nuc, h_pq, (pq|rs)) in the sign-fixed RHF orbitals of the chain,
    every orbital active, and the RHF total energy."""
    S, hcore, eri, e_nuc = integrals(geometry)
    e_elec, C, _ = rhf(S, hcore, eri, n_elec)
    C = fix_signs(C)
    h = C.T @ hcore @ C
    g = np.einsum("pi,qj,rk,sl,pqrs->ijkl", C, C, C, C, eri, optimize=True)
    return e_nuc, h, g, e_elec + e_nuc
