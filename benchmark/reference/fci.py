"""Plain PyTorch determinant space of a closed-shell active space.

A state is a grid C[a, b] over alpha strings a and beta strings b (the
bit k of a string is orbital k; strings in ascending order), with the
alpha operators ordered before the beta ones, so that a spin-summed
E_pq = E^alpha_pq + E^beta_pq acts on the rows and on the columns by
the same string tables (Knowles and Handy, Chem. Phys. Lett. 111, 315
(1984)).  The Hamiltonian

    H = sum_pq k_pq E_pq + 1/2 sum_pqrs (pq|rs) E_pq E_rs,
    k_pq = h_pq - 1/2 sum_r (pr|rq),

is applied through the intermediate D_rs = E_rs C, in blocks of grid
rows so that it fits on one card: W_pq = 1/2 sum_rs (pq|rs) D_rs, then
sigma = sum_pq E_pq W_pq (a scatter over rows for the alpha half, a
gather over columns for the beta half).
"""

from itertools import combinations
from math import comb

import numpy as np
import torch


def strings(n_orb, n_el):
    """The ``n_el``-electron strings of ``n_orb`` orbitals, ascending."""
    out = [sum(1 << k for k in occ)
           for occ in combinations(range(n_orb), n_el)]
    return np.array(sorted(out), dtype=np.int64)


def excitation_tables(n_orb, n_el):
    """(target, sign) of E_pq = a+_p a_q on every string, (n^2, N) each:
    the index of E_pq |I> among the strings and its sign, or index 0 and
    sign 0 where E_pq |I> = 0.  Pair k = p * n_orb + q."""
    strs = strings(n_orb, n_el)
    index = np.full(1 << n_orb, -1, dtype=np.int64)
    index[strs] = np.arange(len(strs))
    n2 = n_orb * n_orb
    tgt = np.zeros((n2, len(strs)), dtype=np.int64)
    sgn = np.zeros((n2, len(strs)))
    for p in range(n_orb):
        for q in range(n_orb):
            k = p * n_orb + q
            has_q = (strs >> q) & 1 == 1
            if p == q:
                tgt[k] = np.arange(len(strs))
                sgn[k] = has_q
                continue
            ok = has_q & ((strs >> p) & 1 == 0)
            new = (strs ^ (1 << q)) | (1 << p)
            par = sum(((strs >> m) & 1) for m in range(min(p, q) + 1,
                                                       max(p, q))) & 1
            tgt[k] = np.where(ok, index[np.where(ok, new, strs)], 0)
            sgn[k] = np.where(ok, 1.0 - 2.0 * par, 0.0)
    return strs, tgt, sgn


class Space:
    """The (n_el alpha, n_el beta) grid of ``n_orb`` orbitals on a device,
    with the tables of E_pq (forward) and of its transpose (gather)."""

    def __init__(self, n_orb, n_el, device, dtype=torch.float64):
        self.n, self.ne = n_orb, n_el
        self.N = comb(n_orb, n_el)
        self.dtype, self.device = dtype, device
        strs, tgt, sgn = excitation_tables(n_orb, n_el)
        self.strings = strs
        n = n_orb
        tr = np.array([q * n + p for p in range(n) for q in range(n)])
        self.tgt = torch.as_tensor(tgt, device=device)
        self.sgn = torch.as_tensor(sgn, dtype=dtype, device=device)
        # (E_pq X)[J] = sign_qp(J) X[target_qp(J)]
        self.gtgt = torch.as_tensor(tgt[tr], device=device)
        self.gsgn = torch.as_tensor(sgn[tr], dtype=dtype, device=device)

    def hf(self):
        """The grid of the determinant with the lowest orbitals filled."""
        C = torch.zeros((self.N, self.N), dtype=self.dtype,
                        device=self.device)
        C[0, 0] = 1.0
        return C

    def block_rows(self, budget=1.5e9):
        """Grid rows per block, so that one (n^2, rows, N) buffer stays
        within ``budget`` bytes."""
        itemsize = torch.finfo(self.dtype).bits // 8
        per_row = self.n * self.n * self.N * itemsize
        return max(1, min(self.N, int(budget // per_row)))


def hamiltonian(space, h, g):
    """(k as (n^2,), 1/2 (pq|rs) as (n^2, n^2)) on the space's device."""
    n = space.n
    k = h - 0.5 * np.einsum("prrq->pq", g)
    kw = dict(dtype=space.dtype, device=space.device)
    return (torch.as_tensor(k.reshape(n * n), **kw),
            torch.as_tensor(0.5 * g.reshape(n * n, n * n), **kw))


def apply_h(space, ham, C):
    """sigma = H C (electronic part) on the grid C (N, N)."""
    k, G = ham
    N, n2 = space.N, space.n * space.n
    sigma = torch.zeros((N + 1, N), dtype=C.dtype, device=C.device)
    rows = space.block_rows()
    for a0 in range(0, N, rows):
        a1 = min(N, a0 + rows)
        R = a1 - a0
        Cb = C[a0:a1]
        # D_rs = E_rs C on rows [a0, a1): alpha half gathers rows, beta
        # half gathers columns
        D = C[space.gtgt[:, a0:a1]] * space.gsgn[:, a0:a1, None]
        D += (torch.gather(Cb.expand(n2, R, N), 2,
                           space.gtgt[:, None, :].expand(n2, R, N))
              * space.gsgn[:, None, :])
        sigma[a0:a1] += torch.einsum("k,kab->ab", k, D)
        W = (G @ D.reshape(n2, R * N)).reshape(n2, R, N)
        del D
        # beta half of sum_pq E_pq W_pq: rows stay, columns gather
        sigma[a0:a1] += (torch.gather(W, 2, space.gtgt[:, None, :].expand(
            n2, R, N)) * space.gsgn[:, None, :]).sum(0)
        # alpha half: row a of W_pq goes to row E_pq a; invalid entries
        # land in the spare row N
        t = torch.where(space.sgn[:, a0:a1] != 0, space.tgt[:, a0:a1], N)
        sigma.index_add_(0, t.reshape(-1),
                         (W * space.sgn[:, a0:a1, None]).reshape(n2 * R, N))
        del W
    return sigma[:N]
