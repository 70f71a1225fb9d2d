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
* E_pq = sum_sigma a^dag_{p sigma} a_{q sigma} (restricted); unrestricted
  operators use raw spin-orbital (mode) indices directly
  (reference active_space.py:52-55, 84-85).

``reorder_unrestricted_rdms`` works on torch tensors (or arrays), on the
RDMs' own device; everything else here is numpy on the host.
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


def annihilation_transfer(R, nm):
    """Gather map for a_R: for each output index i (with mode R empty),
    (a_R psi)[i] = sign[i] * psi[src[i]]; sign 0 where invalid."""
    D = 1 << nm
    idx = np.arange(D, dtype=np.int64)
    bitR = 1 << (nm - 1 - R)
    valid = (idx & bitR) == 0
    src = np.where(valid, idx | bitR, 0)
    sr = _parity_below(src, R, nm)
    sign = np.where(valid, sr.astype(np.float64), 0.0)
    return src, sign


def pair_annihilation_gather(ncas):
    """Gather maps for all W_rs = a_r a_s over spin-orbital (mode)
    indices: (a_r a_s psi)[i] = sign[r,s,i] * psi[src[r,s,i]], shapes
    (nm, nm, D) int32 / int8 (the JAX package keeps float64 signs; the
    values are -1, 0, +1 either way).

    Used for unrestricted 2-RDMs: <a^dag_p a^dag_q a_r a_s> =
    <W_qp psi | W_rs psi> (reference pqc.py:43-66 built the ncas^4
    unrestricted e_pqrs as sparse operators; here one gather and one gram
    cover all elements)."""
    nm = n_modes(ncas)
    D = 1 << nm
    src = np.zeros((nm, nm, D), dtype=np.int32)
    sign = np.zeros((nm, nm, D), dtype=np.int8)
    for r in range(nm):
        s_r, g_r = annihilation_transfer(r, nm)
        for s in range(nm):
            if r == s:
                continue  # a_r a_r = 0
            s_s, g_s = annihilation_transfer(s, nm)
            # compose: (a_r a_s psi)[i] = g_r[i] * (a_s psi)[s_r[i]]
            #        = g_r[i] * g_s[s_r[i]] * psi[s_s[s_r[i]]]
            src[r, s] = s_s[s_r]
            sign[r, s] = g_r * g_s[s_r]
    return src, sign


def single_mode_gather(ncas):
    """Gather maps of every unrestricted a^dag_p a_q over spin-orbital
    (mode) indices, shapes (nm, nm, D) int32 / int8:
    (a^dag_p a_q psi)[i] = sign[p,q,i] * psi[src[p,q,i]]."""
    nm = n_modes(ncas)
    D = 1 << nm
    src = np.zeros((nm, nm, D), dtype=np.int32)
    sign = np.zeros((nm, nm, D), dtype=np.int8)
    for p in range(nm):
        for q in range(nm):
            src[p, q], sign[p, q] = single_mode_transfer(p, q, nm)
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


def epqrs_sparse(p, q, r, s, ncas, up_then_down=False):
    """Restricted chemist-ordered e_pqrs = E_pq E_rs - delta_qr E_ps."""
    op = (epq_sparse(p, q, ncas, up_then_down)
          @ epq_sparse(r, s, ncas, up_then_down))
    if q == r:
        op = op - epq_sparse(p, s, ncas, up_then_down)
    return op


def apq_sparse(p, q, ncas):
    """Unrestricted a^dag_p a_q (spin-orbital indices) as a sparse matrix
    (reference active_space.py:52-55)."""
    return single_mode_transfer_sparse(p, q, n_modes(ncas))


def apqrs_sparse(p, q, r, s, ncas):
    """Unrestricted a^dag_p a^dag_q a_r a_s (reference
    active_space.py:84-85)."""
    nm = n_modes(ncas)
    D = 1 << nm
    if p == q or r == s:
        return sparse.csr_matrix((D, D))

    def _pair(a, b):
        # a_a a_b as a sparse matrix
        s_a, g_a = annihilation_transfer(a, nm)
        s_b, g_b = annihilation_transfer(b, nm)
        rows = np.arange(D)
        src = s_b[s_a]
        sign = g_a * g_b[s_a]
        mask = sign != 0.0
        return sparse.csr_matrix(
            (sign[mask], (rows[mask], src[mask])), shape=(D, D))

    # a^dag_p a^dag_q a_r a_s = (a_q a_p)^dag (a_r a_s)
    return _pair(q, p).T @ _pair(r, s)


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


def reorder_unrestricted_rdms(gamma, Gamma, ncas, to_up_then_down=True):
    """Exact mode permutation of spin-resolved RDMs between the two JW
    orderings (interleaved 2p+sigma <-> up-then-down p+sigma*ncas), as
    torch tensors on the RDMs' device.

    The orderings differ only by a relabeling of the 2*ncas spin modes,
    so converting extracted RDMs is exact and O(nm^4): the route to
    up-then-down RDMs of a sector circuit, whose basis convention is
    fixed interleaved (simulator/circuit.py).  ``to_up_then_down=False``
    applies the inverse permutation."""
    import torch

    nm = 2 * ncas
    # perm[m_target] = m_source: the target ordering's mode m maps to the
    # source ordering's mode of the same (p, sigma)
    if to_up_then_down:
        perm = [mode_of(m % ncas, m // ncas, ncas, False) for m in range(nm)]
    else:
        perm = [mode_of(m // 2, m % 2, ncas, True) for m in range(nm)]
    gamma = torch.as_tensor(gamma)
    Gamma = torch.as_tensor(Gamma)
    perm = torch.as_tensor(perm, device=gamma.device)
    gamma = gamma[perm][:, perm]
    Gamma = Gamma[perm][:, perm][:, :, perm][:, :, :, perm]
    return gamma, Gamma


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
