"""Jordan-Wigner fermion algebra in the occupation-number basis (host side).

Numpy copy of auto_oo_tpu/ops/fermion.py for the PyTorch port (the host
layer must not import jax).  Replaces the OpenFermion capability the
reference used for operator construction (e_pq / e_pqrs sparse operators,
reference utils/active_space.py:29-83 and pqc.py:22-66): instead of
materializing ncas^4 sparse matrices, we precompute *gather maps* so that
every excitation application E_pq |psi> is a single vectorized
gather-multiply, and all RDM elements reduce to one big matmul downstream
(see ops/rdms.py).

Conventions (identical to the reference):
* spin ordering: interleaved by default (mode 2p = spatial p spin-up,
  2p+1 = spin-down, "up-down-up-down"); `up_then_down=True` selects the
  up-then-down layout (mode p = spatial p up, p + ncas = spatial p down)
  — both orderings of reference utils/active_space.py:29-57;
* basis index is big-endian in qubit/mode order: mode 0 is the most
  significant bit (OpenFermion/PennyLane statevector convention);
* E_pq = sum_sigma a^dag_{p sigma} a_{q sigma} (restricted).

The port keeps what its host layer (moldata/fci.py, the grid maps and
the grid gate builders) calls; the unrestricted operator builders come
with the unrestricted routes.
"""

import numpy as np
from scipy import sparse


def n_modes(ncas):
    return 2 * ncas


def occ_bit(idx, mode, nm):
    """Occupation of `mode` in basis state(s) `idx` (big-endian)."""
    return (idx >> (nm - 1 - mode)) & 1


def popcount(x):
    """Vectorized population count (uint64 path: np.bitwise_count on
    int64 falls back to a scalar loop ~100x slower on this numpy)."""
    x = np.asarray(x)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x.astype(np.uint64)).astype(np.int64)
    cnt = np.zeros(x.shape, dtype=np.int64)
    m = x.astype(np.int64).copy()
    while np.any(m):
        cnt += m & 1
        m >>= 1
    return cnt


def _parity_below(idx, mode, nm):
    """(-1)^{number of occupied modes k < mode} as +-1."""
    if mode == 0:
        return np.ones_like(idx)
    shift = nm - mode
    return 1 - 2 * (popcount(np.asarray(idx) >> shift) & 1)


def single_mode_transfer(P, Q, nm):
    """Gather map for a^dag_P a_Q over the full 2^nm space.

    Returns (src, sign): for each output index i,
      (a^dag_P a_Q psi)[i] = sign[i] * psi[src[i]]
    with sign 0 where the operator annihilates.  Handles P == Q (number
    operator) as a diagonal map.
    """
    D = 1 << nm
    idx = np.arange(D, dtype=np.int64)
    if P == Q:
        sign = occ_bit(idx, P, nm).astype(np.float64)
        return idx, sign
    bitP = 1 << (nm - 1 - P)
    bitQ = 1 << (nm - 1 - Q)
    has_P = (idx & bitP) != 0
    has_Q = (idx & bitQ) != 0
    valid = has_P & (~has_Q)  # output states: P occupied, Q empty
    src = np.where(valid, idx ^ bitP ^ bitQ, 0)
    # sign: apply a_Q to src (parity below Q in src), then a^dag_P
    # (parity below P in src after removing Q)
    sq = _parity_below(src, Q, nm)
    mid = src ^ bitQ
    sp = _parity_below(mid, P, nm)
    sign = np.where(valid, (sq * sp).astype(np.float64), 0.0)
    return src, sign


def mode_of(p, sigma, ncas, up_then_down=False):
    """JW mode index of spatial orbital p, spin sigma (0=up, 1=down)."""
    return p + sigma * ncas if up_then_down else 2 * p + sigma


def epq_gather(ncas, up_then_down=False):
    """Gather maps for all restricted E_pq.

    Returns (src, sign) with shape (ncas, ncas, 2, D):
      (E_pq psi)[i] = sum_sigma sign[p,q,sigma,i] * psi[src[p,q,sigma,i]].
    """
    nm = n_modes(ncas)
    D = 1 << nm
    src = np.zeros((ncas, ncas, 2, D), dtype=np.int32)
    sign = np.zeros((ncas, ncas, 2, D), dtype=np.float64)
    for p in range(ncas):
        for q in range(ncas):
            for s in range(2):
                sp, sg = single_mode_transfer(
                    mode_of(p, s, ncas, up_then_down),
                    mode_of(q, s, ncas, up_then_down), nm)
                src[p, q, s] = sp
                sign[p, q, s] = sg
    return src, sign


def single_mode_transfer_sparse(P, Q, nm):
    """a^dag_P a_Q as a scipy CSR matrix over the full space."""
    src, sign = single_mode_transfer(P, Q, nm)
    D = 1 << nm
    rows = np.arange(D)
    mask = sign != 0.0
    return sparse.csr_matrix(
        (sign[mask], (rows[mask], src[mask])), shape=(D, D))


def epq_sparse(p, q, ncas, up_then_down=False):
    """Restricted E_pq as a sparse matrix over the full space."""
    nm = n_modes(ncas)
    return (single_mode_transfer_sparse(
                mode_of(p, 0, ncas, up_then_down),
                mode_of(q, 0, ncas, up_then_down), nm)
            + single_mode_transfer_sparse(
                mode_of(p, 1, ncas, up_then_down),
                mode_of(q, 1, ncas, up_then_down), nm))


def s_plus_sparse(ncas):
    """S+ = sum_p a^dag_{p alpha} a_{p beta} (alpha = even modes)."""
    nm = n_modes(ncas)
    D = 1 << nm
    out = sparse.csr_matrix((D, D))
    for p in range(ncas):
        out = out + single_mode_transfer_sparse(2 * p, 2 * p + 1, nm)
    return out


def sz_diag(ncas):
    """Diagonal of S_z over the full space."""
    nm = n_modes(ncas)
    idx = np.arange(1 << nm, dtype=np.int64)
    sz = np.zeros(idx.shape, dtype=np.float64)
    for p in range(ncas):
        sz += 0.5 * occ_bit(idx, 2 * p, nm)
        sz -= 0.5 * occ_bit(idx, 2 * p + 1, nm)
    return sz


def s2_sparse(ncas):
    """S^2 = S+ S- + Sz^2 - Sz as a sparse matrix (dense via .toarray())."""
    sp = s_plus_sparse(ncas)
    sz = sz_diag(ncas)
    D = sz.size
    szm = sparse.diags(sz)
    return sp @ sp.conj().T + szm @ szm - szm


def sz_sparse(ncas):
    """S_z as a sparse diagonal matrix over the full space."""
    return sparse.diags(sz_diag(ncas))


def sector_basis(ncas, nelec):
    """Determinant indices of the (n_alpha, n_beta) sector, ascending.

    nelec may be an int (split as evenly as possible, beta gets the
    remainder like PySCF) or an (n_alpha, n_beta) tuple.
    """
    if isinstance(nelec, (tuple, list)):
        na, nb = nelec
    else:
        nb = nelec // 2
        na = nelec - nb
    nm = n_modes(ncas)
    # O(D_sector): enumerate alpha / beta occupation strings and combine —
    # never materializes the 4^ncas space, so (14e,14o) (C(14,7)^2 = 11.8M
    # determinants vs 2^28 = 268M full) stays host-feasible
    from itertools import combinations

    def strings(n_occ, spin):
        out = np.fromiter(
            (sum(1 << (nm - 1 - (2 * p + spin)) for p in occ)
             for occ in combinations(range(ncas), n_occ)),
            dtype=np.int64)
        return out if out.size else np.zeros(1, dtype=np.int64)

    A = strings(na, 0)
    B = strings(nb, 1)
    return np.sort((A[:, None] | B[None, :]).ravel())


def project_sector(op, basis):
    """Restrict a full-space sparse operator to a sector basis."""
    return op[np.ix_(basis, basis)]


def hf_bitstring(ncas, nelec):
    """Occupation vector of the HF reference determinant (interleaved
    ordering), as an int basis index and as a 0/1 vector (matching
    qml.qchem.hf_state semantics, reference pqc.py:131).

    ``nelec`` may be an (n_alpha, n_beta) tuple for OPEN-SHELL references:
    alpha electrons fill modes 0, 2, ... and beta electrons modes 1, 3,
    ...; the closed-shell integer form (first `nelec` modes occupied) is
    the (ceil(n/2), floor(n/2)) special case."""
    nm = n_modes(ncas)
    vec = np.zeros(nm, dtype=np.int64)
    if isinstance(nelec, (tuple, list)):
        na, nb = int(nelec[0]), int(nelec[1])
        if na > ncas or nb > ncas or na < 0 or nb < 0:
            raise ValueError(f"(n_alpha, n_beta) = ({na}, {nb}) does not "
                             f"fit in {ncas} spatial orbitals")
        vec[0:2 * na:2] = 1
        vec[1:2 * nb:2] = 1
    else:
        vec[:nelec] = 1
    idx = 0
    for m, o in enumerate(vec):
        idx = (idx << 1) | int(o)
    return idx, vec
