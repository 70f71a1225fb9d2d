"""Statevector and two-electron-transform sharding.

Port of auto_oo_tpu/parallel/statevector.py.  The two memory-scaling
axes of the problem are the statevector (4^ncas, or the sector's
C(n,na) C(n,nb)) and the AO integral tensor (nao^4).  The JAX package
annotates shardings and lets GSPMD partition one program; here each rank
runs its block and calls the collectives itself:

* The state axis is split into one block per rank (``state_shard``):
  on a string grid, blocks of grid rows (``grid_sharded.RowShard``, the
  grid kernels on each rank's rows); in the full space, blocks of the
  canonical basis (``ColShard``: the E_pq element gathers of each rank's
  columns from the all-gathered state, and the reduction as a scatter
  through the inverse maps finished by one reduce_scatter).  Phi stays in
  its blocks; grams are all_reduce'd (n2, n2) partials.
* The gate sweep runs on each rank's whole copy of the state, the JAX
  package's ``shard_gates=False`` layout for every call (ROADMAP.md
  queue 3 records the difference and its memory), and the state is
  split from the E_pq / gram stage on.  As every rank holds the whole
  state, Phi and the H-apply read it directly (``whole``); the
  collectives only combine per-rank results.
* The 2e transform splits the LEADING AO axis of the nao^4 tensor, all
  four axes zero-padded to a multiple of the axis size: each of the four
  chained one-index contractions contracts the split axis into a partial
  tensor, and one reduce_scatter both sums the partials and splits the
  next leading axis.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import grid as _grid
from ..ops import rdms as _rdms
from ..ops import transforms as _tr
from ..ops.grid import GridMaps
from ..ops.linalg import expm, gram_last
from .distributed import Axis, all_gather, all_reduce, reduce_scatter


def _move_last_first(fn, x):
    """fn applied with x's last axis moved to the front, and moved back."""
    return fn(x.movedim(-1, 0)).movedim(0, -1).contiguous()


class WholeState:
    """No state axis: the whole state on every rank (a tangent-only
    mesh); the E_pq work is the single-device one."""

    axis = None

    def __init__(self, maps, ncas):
        self.maps, self.ncas = maps, ncas

    def local(self, x):
        return x

    def whole(self, x):
        return x

    def gather(self, x_loc):
        return x_loc

    def flat(self, full):
        return full

    def reduce(self, x):
        return x

    def phi(self, full):
        return _rdms.apply_epq_all(full, self.ncas, self.maps)

    def ham(self, c1eff, c2, full, phi=None):
        """H x (no c0) of whole states (given their Phi, else built)."""
        n2 = self.maps.n2
        if phi is None:
            phi = self.phi(full)
        Y = torch.matmul(c2.reshape(n2, n2).to(full.dtype), phi)
        Y.addcmul_(c1eff.reshape(n2).to(full.dtype)[:, None],
                   full[..., None, :])
        if isinstance(self.maps, GridMaps):
            return _grid.epq_sum(Y, self.maps)
        return _rdms.epq_sum_flat(Y, self.maps)


def _flat_inverse(maps):
    """Inverse of the flat E_pq maps: dst[s, pq, j] = the output index that
    reads source j for (s, pq), dsg its sign (0/0 where none does); each
    (s, pq) map is a partial injection."""
    src = maps.src.cpu().numpy()
    sign = maps.sign.cpu().numpy()
    dst = np.zeros_like(src)
    dsg = np.zeros_like(sign)
    for s in range(2):
        ks, iis = np.nonzero(sign[s])
        dst[s, ks, src[s, ks, iis]] = iis
        dsg[s, ks, src[s, ks, iis]] = sign[s, ks, iis]
    return dst, dsg


class ColShard:
    """This rank's block of the basis of flat maps (the full space) on one
    mesh axis: the state padded to a multiple of the axis size, Phi of
    the rank's columns gathered from the all-gathered state, and the
    E_pq reduction as a scatter of the rank's columns through the inverse
    maps into a whole-length partial, summed and split by one
    reduce_scatter."""

    def __init__(self, maps, ncas, axis):
        self.maps, self.ncas, self.axis = maps, ncas, axis
        D = maps.dim
        self.n_loc, (lo, hi) = axis.block(D)
        self.D, self.D_pad = D, self.n_loc * axis.size
        self.lo, self.hi = lo, hi
        cols = (lambda t: F.pad(t, (0, self.D_pad - D))[..., lo:hi]
                .contiguous())
        self.loc_maps = _rdms.FlatMaps.__new__(_rdms.FlatMaps)
        self.loc_maps.device = maps.device
        self.loc_maps.src, self.loc_maps.sign = cols(maps.src), cols(
            maps.sign)
        dst, dsg = _flat_inverse(maps)
        self.dst = cols(torch.as_tensor(dst, device=maps.device).long())
        self.dsg = cols(torch.as_tensor(dsg, device=maps.device))

    def local(self, x):
        """This rank's columns of whole states (..., D)."""
        blk = x[..., self.lo:min(self.hi, self.D)]
        return F.pad(blk, (0, self.n_loc - blk.shape[-1])).contiguous()

    def whole(self, x):
        """Whole states (..., D) as Phi reads them: themselves."""
        return x

    def gather(self, x_loc):
        return _move_last_first(lambda v: all_gather(v, self.axis),
                                x_loc)[..., :self.D]

    def flat(self, full):
        return full

    def reduce(self, x):
        return all_reduce(x.contiguous(), self.axis)

    def phi(self, full):
        return _rdms.apply_epq_all(full, self.ncas, self.loc_maps)

    def ham(self, c1eff, c2, full, phi=None):
        """This rank's columns of H x (no c0) of whole states, given the
        Phi of its columns (else built)."""
        n2 = self.maps.n2
        if phi is None:
            phi = self.phi(full)
        lead = phi.shape[:-2]
        Y = torch.matmul(c2.reshape(n2, n2).to(full.dtype), phi)
        Y.addcmul_(c1eff.reshape(n2).to(full.dtype)[:, None],
                   self.local(full)[..., None, :])
        part = Y.new_zeros(lead + (self.D_pad,))
        for s in range(2):
            part.index_add_(-1, self.dst[s].reshape(-1),
                            (Y * self.dsg[s].to(Y.dtype)).reshape(
                                lead + (-1,)))
        return _move_last_first(lambda v: reduce_scatter(v, self.axis),
                                part)


def state_shard(maps, ncas, axis):
    """The state-axis split of a circuit's maps on ``axis`` (an Axis, or
    None for no split): blocks of grid rows on GridMaps, blocks of the
    basis on FlatMaps."""
    if axis is None:
        return WholeState(maps, ncas)
    if isinstance(maps, GridMaps):
        from .grid_sharded import RowShard
        return RowShard(maps, axis)
    return ColShard(maps, ncas, axis)


def sharded_state_fn(pqc, mesh, axis="tp"):
    """theta -> this rank's block of |psi(theta)> (canonical order, padded
    with zeros to a multiple of the axis size): the JAX function's
    sharded output.  The gate sweep runs whole on every rank."""
    ax = Axis(mesh, axis)
    per, (lo, hi) = ax.block(pqc.state_dim)

    def run(theta):
        psi = pqc.state(theta)
        return F.pad(psi, (0, per * ax.size - psi.shape[-1]))[lo:hi]

    return run


def _rdms_of(pqc, S, psi):
    """(gamma, Gamma) of a state in the maps' order through the split S:
    Phi of the rank's block, grams summed over the axis."""
    x_loc = S.local(psi)
    phi = S.phi(S.whole(psi))
    n2 = phi.shape[-2]
    phi = phi.reshape(n2, -1)
    gamma = S.reduce(gram_last(phi, x_loc.reshape(-1).conj()).real)
    corr = S.reduce(gram_last(phi.conj(), phi).real)
    return _grid.assemble_rdms(gamma, corr, pqc.ncas)


def sharded_rdms_fn(pqc, mesh, axis="tp", shard_gates=False):
    """theta -> (gamma, Gamma), whole on every rank, with the state and
    its Phi split over ``axis`` from the E_pq stage on (grid rows on a
    sector, basis blocks in the full space).  The gate sweep runs whole on
    every rank: the JAX package's ``shard_gates=False`` layout.
    ``shard_gates=True`` (the JAX package's default, the sweep itself
    split) raises NotImplementedError."""
    if shard_gates:
        raise NotImplementedError(
            "shard_gates=True: the port runs the gate sweep whole on every "
            "rank (ROADMAP.md queue 3); pass shard_gates=False")
    S = state_shard(pqc.epq_maps, pqc.ncas, Axis(mesh, axis))

    def run(theta):
        return _rdms_of(pqc, S, pqc._state_impl_grid(pqc._as_theta(theta)))

    return run


def _pad_to(n, k):
    return -(-n // k) * k


def _int2e_split(int2e_ao, mo, ax):
    """The MO ERI tensor, whole on every rank, with the leading AO axis
    split over ``ax`` through the four contractions."""
    nao = int2e_ao.shape[0]
    npad = _pad_to(nao, ax.size)
    _per, (lo, hi) = ax.block(nao)
    pad4 = (0, npad - nao) * 4
    M = F.pad(int2e_ao, pad4)[lo:hi]
    C = F.pad(mo, (0, npad - nao, 0, npad - nao))
    for _ in range(4):
        # this rank's rows of the contracted axis, then the sum over the
        # ranks split on the next (cycled) leading axis
        M = reduce_scatter(torch.tensordot(M, C[lo:hi], dims=([0], [0])),
                           ax)
    return all_gather(M, ax)[:nao, :nao, :nao, :nao]


def sharded_int2e_transform_fn(mesh, axis="tp"):
    """(int2e_ao, mo_coeff) -> the MO-basis ERI tensor, whole on every
    rank, with the nao^4 tensor split on its leading axis through the
    four chained contractions (all four axes zero-padded to a multiple of
    the axis size: zero rows contract to zero, so the [:nao]^4 block is
    exact)."""
    ax = Axis(mesh, axis)
    return lambda int2e_ao, mo: _int2e_split(int2e_ao, mo, ax)


def sharded_energy_fn(oo, mesh, sv_axis="tp", eri_axis="tp"):
    """(theta, kappa, oao_mo_coeff) -> E with the state split over
    ``sv_axis`` from the E_pq stage on and the 2e transform split over
    ``eri_axis``: the forward pass on the mesh.  Works for sector
    circuits."""
    pqc = oo.pqc
    S = state_shard(pqc.epq_maps, pqc.ncas, Axis(mesh, sv_axis))
    ax_eri = Axis(mesh, eri_axis)

    def run(theta, kappa, oao_mo_coeff):
        theta = pqc._as_theta(theta)
        kappa = torch.as_tensor(kappa, dtype=theta.dtype,
                                device=theta.device)
        mo = oo.oao_coeff @ oao_mo_coeff @ expm(
            -oo.kappa_vector_to_matrix(kappa))
        gamma, Gamma = _rdms_of(pqc, S, pqc._state_impl_grid(theta))
        h1 = _tr.int1e_transform(oo.int1e_ao, mo)
        g2 = _int2e_split(oo.int2e_ao, mo, ax_eri)
        c0, c1, c2 = _tr.molecular_hamiltonian_coefficients(
            oo.nuc, h1, g2, oo._occ, oo._act)
        return _tr.energy_from_rdms(c0, c1, c2, gamma, Gamma)

    return run
