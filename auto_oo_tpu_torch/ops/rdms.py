"""Spin-summed RDMs from a statevector, on the string grid or the full space.

Port of auto_oo_tpu/ops/rdms.py (``apply_epq_all`` and
``rdms_from_state``):

1. Phi[p,q] = E_pq |psi> for ALL (p,q) at once;
2. gamma = Phi @ psi                                    (one matvec)
3. <E_pq E_rs> = <E_qp psi | E_rs psi> = Phi @ Phi^T    (one matmul)
4. Gamma = that matrix minus the delta_qr gamma_ps contraction term
   (e_pqrs = E_pq E_rs - delta_qr E_ps).

Two kinds of maps give step 1.  On a particle sector, ``GridMaps``
(ops/grid.py): ``phi_all``, the gather_two_spin kernel, on GRID-ordered
states.  In the full 4^ncas space, ``FlatMaps``: per spin one element
gather psi[src_s] scaled by sign_s, on the canonical basis order — plain
PyTorch indexing, as the JAX package's flat branch is plain XLA.  The
JAX package computes the flat maps from bit arithmetic above D = 2^16,
only to keep them out of XLA program constants; the port keeps the
tables (int32 and int8 on the device, 42 MB at (8e,8o)).

The JAX package's ``gram_last`` / ``small_matmul_free_last`` sliced the
large state axis only to bound the TPU's f64-emulation temporaries; here
a float64 gram is one ``torch.matmul``, and a float32 one (the mixed
precision mode) is ``linalg.gram_last``'s, summed in float64 pieces.
States may be complex (a callable ansatz's, or a state handed to
``get_rdms_from_state``): every inner product conjugates the bra side
and takes the real part, as in the JAX package (reference
pqc.py:214-216); for the real states of the built-in ansatze both are
no-ops.

``rdms_from_state_unrestricted`` gives the spin-resolved RDMs over the
2 ncas modes of a full-space state: gamma from the single-mode maps of
every a^dag_p a_q, Gamma from one gram of the pair-annihilation vectors
W_rs psi = a_r a_s psi (ops/fermion.pair_annihilation_gather), an
(nm^2, D) element gather, plain PyTorch as it is plain XLA in the JAX
package.  ``build_flat_maps(ncas, up_then_down=True)`` gives the E_pq
maps of the up-then-down mode ordering.

``s2_matrix`` / ``sz_matrix`` are the dense spin operators of the full
space (the JAX package's, reference utils/active_space.py:243-253): 4^ncas
squared entries, for the full-space circuits of a few orbitals only.
"""

from functools import lru_cache

import numpy as np
import torch

from ..config import get_device
from . import fermion
from .linalg import gram_last
from .grid import (GridMaps, _pair_chunk, assemble_rdms, phi_all,
                   rdms_rows, stream_plan, to_grid)


class FlatMaps:
    """E_pq gather maps over the full space, on one device:

      src:  (2, n2, D) int32, src[s, p*ncas+q, i] = the basis index that
            E_pq^s reads for output index i
      sign: (2, n2, D) int8, its sign (0 where E_pq^s annihilates)

    so that (E_pq psi)[i] = sum_s sign[s, pq, i] * psi[src[s, pq, i]].
    ``src`` and ``sign`` are numpy arrays or tensors; a tensor already
    on ``device`` is taken without a copy through the host."""

    def __init__(self, src, sign, device=None):
        self.device = get_device(device)
        self.src = self._table(src, torch.int32, np.int32)
        self.sign = self._table(sign, torch.int8, np.int8)
        # the reduction indexes the flattened (n2 * D) axis with int32
        if self.n2 * self.dim >= 1 << 31:
            raise ValueError(f"flat E_pq maps of {self.n2} pairs over "
                             f"D = {self.dim} exceed int32 indexing")

    def _table(self, t, dtype, np_dtype):
        if torch.is_tensor(t):
            return t.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(t, dtype=np_dtype),
                               device=self.device)

    @property
    def n2(self):
        return self.src.shape[1]

    @property
    def dim(self):
        return self.src.shape[2]


def build_flat_maps(ncas, up_then_down=False, device=None):
    """FlatMaps of all ncas^2 pairs over the 4^ncas space, in the
    interleaved spin ordering or (``up_then_down``) the up-then-down one,
    on ``device``."""
    src, sign = fermion.epq_gather(ncas, up_then_down)   # (n, n, 2, D)
    n2, D = ncas * ncas, src.shape[-1]
    return FlatMaps(src.transpose(2, 0, 1, 3).reshape(2, n2, D),
                    sign.transpose(2, 0, 1, 3).reshape(2, n2, D),
                    device=device)


def _check_maps(maps):
    if not isinstance(maps, (GridMaps, FlatMaps)):
        raise TypeError(f"expected GridMaps or FlatMaps, got "
                        f"{type(maps).__name__}")


def apply_epq_all(psi, ncas, maps):
    """Phi[..., p*ncas+q, :] = E_pq |psi> for all pairs, shape
    (..., ncas^2, D); psi and the result are in the maps' order (GRID
    order for GridMaps, canonical for FlatMaps)."""
    _check_maps(maps)
    if isinstance(maps, GridMaps):
        return phi_all(psi, maps)
    shape = psi.shape[:-1] + (maps.n2, maps.dim)
    out = None
    for s in range(2):
        term = psi.index_select(-1, maps.src[s].reshape(-1)).reshape(
            shape) * maps.sign[s]
        out = term if out is None else out + term
    return out


def epq_sum_flat(Y, maps):
    """out[..., i] = sum_pq (E_pq Y[..., pq, :])[i] over FlatMaps: per
    spin a gather of each pair's own row of Y, scaled and summed over
    the pairs (the JAX package's row-wise flat reduction)."""
    lead = Y.shape[:-2]
    n2, D = maps.n2, maps.dim
    Yf = Y.reshape(lead + (n2 * D,))
    rows = torch.arange(n2, dtype=torch.int32, device=Y.device)[:, None] * D
    out = None
    for s in range(2):
        term = (Yf.index_select(-1, (maps.src[s] + rows).reshape(-1))
                .reshape(lead + (n2, D)) * maps.sign[s]).sum(dim=-2)
        out = term if out is None else out + term
    return out


def rdms_from_gram(phi, psi, ncas):
    """(gamma, Gamma) from Phi = E_pq psi and psi (one order for both);
    float64 whatever the state's dtype (a float32 state's grams are
    ``gram_last``'s); a complex state's bra side is conjugated and the
    real part taken."""
    # gamma[pq] = Re <psi|E_pq psi>; corr[(q,p),(r,s)] = Re <E_qp psi|E_rs
    # psi> = Re <psi|E_pq E_rs|psi>
    return assemble_rdms(gram_last(phi, psi.conj()).real,
                         gram_last(phi.conj(), phi).real, ncas)


def rdms_from_state(psi, ncas, maps, grid_order=False, plan=None):
    """Spin-summed restricted (gamma, Gamma), chemist ordering, of a real
    or complex state.  Over FlatMaps psi is in the canonical full-space
    order.  Over GridMaps psi arrives in canonical order and is converted
    once, unless ``grid_order`` (the gram and dot are invariant under any
    common permutation of both operands); given a ``plan`` (a grid.StreamPlan),
    or where one (n^2, D) Phi does not fit its block, Phi streams over
    grid A-rows (grid.rdms_rows) in chunks of ``plan.row_chunk`` rows
    (default grid.stream_plan)."""
    _check_maps(maps)
    if isinstance(maps, GridMaps):
        if not grid_order:
            psi = to_grid(psi, maps)
        if plan is not None or _pair_chunk(1, psi.shape[-1], maps.n2,
                                           psi.element_size()) < maps.n2:
            plan = plan or stream_plan(maps, 1, psi.element_size())
            return rdms_rows(psi, maps, ncas, plan.row_chunk)
    return rdms_from_gram(apply_epq_all(psi, ncas, maps), psi, ncas)


@lru_cache(maxsize=None)
def _mode_tables(kind, ncas, device):
    """(src, sign) of the unrestricted single-mode ("single") or
    pair-annihilation ("pair") maps, (nm^2, D) int32 / int8 on ``device``,
    built once per (ncas, device)."""
    make = (fermion.single_mode_gather if kind == "single"
            else fermion.pair_annihilation_gather)
    src, sign = make(ncas)
    nm2 = src.shape[0] * src.shape[1]
    return (torch.as_tensor(src.reshape(nm2, -1), device=device),
            torch.as_tensor(sign.reshape(nm2, -1), device=device))


def _mode_gather(psi, kind, ncas):
    src, sign = _mode_tables(kind, ncas, psi.device)
    return psi.index_select(-1, src.reshape(-1)).reshape(src.shape) * sign


def rdms_from_state_unrestricted(psi, ncas):
    """Spin-resolved (unrestricted) RDMs of a full-space state over its
    2 ncas modes, in the state's own mode ordering: gamma_pq =
    <a^dag_p a_q>, Gamma_pqrs = <a^dag_p a^dag_q a_r a_s> (reference
    pqc.py:192-218 with restricted=False), float64 for a real or complex
    state: <a^dag_p a^dag_q a_r a_s> = <W_qp psi | W_rs psi> with W_rs =
    a_r a_s, one gram of the (nm^2, D) gather."""
    nm = 2 * ncas
    W = _mode_gather(psi, "pair", ncas)                   # (nm^2, D)
    # corr[(q,p),(r,s)] -> Gamma[p,q,r,s]
    Gamma = gram_last(W.conj(), W).real.reshape(nm, nm, nm, nm).permute(
        1, 0, 2, 3)
    gamma = gram_last(_mode_gather(psi, "single", ncas),
                      psi.conj()).real.reshape(nm, nm)
    return gamma, Gamma


@lru_cache(maxsize=None)
def _spin_matrix(kind, ncas, device):
    op = fermion.s2_sparse(ncas) if kind == "s2" else fermion.sz_sparse(
        ncas)
    return torch.as_tensor(op.toarray(), dtype=torch.float64, device=device)


def s2_matrix(ncas, device=None):
    """Dense S^2 over the 2^(2 ncas) space, on ``device`` (built once per
    (ncas, device))."""
    return _spin_matrix("s2", ncas, get_device(device))


def sz_matrix(ncas, device=None):
    """Dense S_z over the 2^(2 ncas) space, on ``device``."""
    return _spin_matrix("sz", ncas, get_device(device))
