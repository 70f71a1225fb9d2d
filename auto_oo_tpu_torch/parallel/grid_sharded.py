"""Row-sharded string-grid sector engines (distributed Knowles-Handy).

Port of auto_oo_tpu/parallel/grid_sharded.py.  The (Na, Nb) string grid
is partitioned over its ALPHA-string rows along one mesh axis (padded to
a multiple of the axis size, the padded rows' tables carrying sign 0):
the spin factorization of ops/grid.py keeps every beta-spin operation
inside a rank's own rows, and confines the traffic to the alpha halves:

* Phi of a rank's rows: one ``gather_two_spin`` launch per row chunk on
  the whole state, which every rank holds (D amplitudes, the small
  object; Phi, n2 x D, never leaves its rank);
* the Hamiltonian apply: per row chunk Y = C2 Phi + c1eff x, its beta
  half reduced in place into the chunk's own rows
  (``gather_reduce_cols``), its alpha half added into a full-height
  accumulator through the inverse maps (``scatter_rows``), then ONE
  ``reduce_scatter`` of the accumulator (``grid_hosted._ham_chunk``,
  the hosted route's chunk, on the padded maps);
* RDM grams and dots: one ``all_reduce`` of (n2, n2) / n2 / scalars.

A rank's rows are streamed in sub-chunks of at most ``_LOCAL_BLOCK_BYTES``
of Phi (a module attribute, patchable as the JAX test patches its own).

The gate sweeps run on each rank's full copy of the state (the JAX
package partitions them under GSPMD; ROADMAP.md queue 3 records the
difference and its memory), and the engines shard from the E_pq / gram /
H-apply stage on.  Inputs are whole states on every rank; outputs that
the JAX functions replicate are whole on every rank.

``grid2d_nr_fns`` composes the row axis with the tangent axis of the
Newton core: rank (i, j) of a (tangent, row) mesh takes tangent block i
of the Jacobian on row block j of the grid.
"""

import copy

import torch
import torch.nn.functional as F

from ..ops import grid as _grid
from ..ops import grid_hosted as _gh
from ..ops.grid import GridMaps
from ..ops.linalg import gram_last
from .distributed import Axis, all_gather, all_reduce, reduce_scatter

# per-rank ceiling on one materialized (n2, rows, Nb) Phi / Y block: above
# it a rank's rows stream in sub-chunks (the JAX package's 1 GB)
_LOCAL_BLOCK_BYTES = 1 << 30


def _local_row_chunk(n2, rows, nb, itemsize):
    per_row = n2 * nb * itemsize
    if rows * per_row <= _LOCAL_BLOCK_BYTES:
        return rows
    return max(1, int(_LOCAL_BLOCK_BYTES // per_row))


def padded_maps(gm, n):
    """``gm`` with its row-axis tables (srcA, sgnA, tA) padded to a
    multiple of n rows, the padded entries src 0 and sign 0 (they feed
    nothing and receive nothing); ``gm`` itself when n divides Na.  The
    beta tables and g2s/s2g are shared; derived tables are cached on the
    result, which is cached on ``gm``."""
    pad = (-gm.Na) % n
    if not pad:
        return gm

    def make():
        pm = copy.copy(gm)
        pm._full, pm.pairs, pm._cache = pm, None, {}
        widen = (lambda t: F.pad(t, (0, pad)))
        pm.srcA, pm.srcA_long = widen(gm.srcA), widen(gm.srcA_long)
        sgnA, tB, sgnB, tA = gm._signs
        pm._signs = (widen(sgnA), tB, sgnB, widen(tA))
        pm._scales = {}
        for dt in gm._scales:
            pm.scales(dt)
        return pm
    return gm._cached(("padded", n), make)


class RowShard:
    """This rank's block of grid rows on one mesh axis: the padded maps,
    the rows [lo, hi) of the Na_pad padded rows, and the grid operations
    on them (Phi of the rows, the scatter-form H-apply finished by one
    reduce_scatter, the all-gathers of row blocks).  Local blocks are
    flat (..., rows * Nb); whole (``full``) states are padded grids
    (..., Na_pad, Nb).  The same interface as statevector.ColShard and
    WholeState (the state splits of the Newton core)."""

    def __init__(self, gm, axis):
        self.gm = gm
        self.axis = axis
        self.pm = padded_maps(gm, axis.size)
        self.rows, (self.lo, self.hi) = axis.block(gm.Na)
        self.Na_pad = self.rows * axis.size

    def chunks(self, itemsize):
        """[r0, r1) sub-chunks of this rank's rows (``_LOCAL_BLOCK_BYTES``
        of Phi each at most)."""
        step = _local_row_chunk(self.gm.n2, self.rows, self.gm.Nb, itemsize)
        return [(r0, min(self.hi, r0 + step))
                for r0 in range(self.lo, self.hi, step)]

    def local(self, x):
        """This rank's rows of flat GRID-ordered states (..., D), flat."""
        gm = self.gm
        xg = x.reshape(x.shape[:-1] + (gm.Na, gm.Nb))
        blk = xg[..., self.lo:min(self.hi, gm.Na), :]
        blk = F.pad(blk, (0, 0, 0, self.rows - blk.shape[-2]))
        return blk.reshape(x.shape[:-1] + (-1,)).contiguous()

    def whole(self, x):
        """Flat GRID-ordered states (..., D) -> padded grids (..., Na_pad,
        Nb), as Phi reads them (no collective: every rank holds them)."""
        gm = self.gm
        xg = x.reshape(x.shape[:-1] + (gm.Na, gm.Nb))
        if self.Na_pad == gm.Na:
            return xg
        return F.pad(xg, (0, 0, 0, self.Na_pad - gm.Na))

    def gather(self, x_loc):
        """Every rank's flat row blocks (..., rows * Nb) -> whole padded
        grids (..., Na_pad, Nb)."""
        blk = x_loc.reshape(x_loc.shape[:-1] + (self.rows, self.gm.Nb))
        if blk.dim() == 2:
            return all_gather(blk, self.axis)
        return all_gather(blk.movedim(-2, 0), self.axis).movedim(
            0, -2).contiguous()

    def flat(self, full):
        """(..., Na_pad, Nb) -> flat GRID-ordered (..., D)."""
        gm = self.gm
        return full[..., :gm.Na, :].reshape(full.shape[:-2] + (gm.dim,))

    def reduce(self, x):
        return all_reduce(x.contiguous(), self.axis)

    def phi_rows(self, full, r0, r1):
        """Phi of grid rows [r0, r1) of whole padded grids: (..., n2,
        r1 - r0, Nb), one ``gather_two_spin`` launch (two for a complex
        state)."""
        return _grid._phi_chunk(full.contiguous(), self.pm, r0, r1)

    def phi(self, full):
        """Phi of this rank's rows, flat: (..., n2, rows * Nb)."""
        out = self.phi_rows(full, self.lo, self.hi)
        return out.reshape(out.shape[:-2] + (-1,))

    def ham(self, c1eff, c2, full, phi=None):
        """This rank's rows of H x (no c0), flat (..., rows * Nb), for
        whole padded grids ``full``: per grid the hosted route's
        scatter-form chunk into a full-height accumulator
        (``grid_hosted._ham_chunk``), then one reduce_scatter.  Given
        ``phi`` (the Phi of this rank's rows, ``phi``'s layout) it is
        one chunk; else the rows stream in sub-chunks.  A complex x
        takes its real and imaginary parts in turn (H has real
        coefficients)."""
        if full.dim() > 2:
            return torch.stack([
                self.ham(c1eff, c2, full[b], None if phi is None else phi[b])
                for b in range(full.shape[0])])
        if full.is_complex():
            parts = [(full.real, None if phi is None else phi.real),
                     (full.imag, None if phi is None else phi.imag)]
            re, im = (self.ham(c1eff, c2, f.contiguous(),
                               None if p is None else p.contiguous())
                      for f, p in parts)
            return torch.complex(re, im)
        gm, pm = self.gm, self.pm
        c1, C2 = _gh._coefficients(c1eff, c2, gm, full.dtype)
        acc = torch.zeros_like(full)
        if phi is not None:
            _gh._ham_chunk(acc, phi.reshape(gm.n2, self.rows, gm.Nb),
                           full[self.lo:self.hi], c1, C2, pm, self.lo,
                           self.hi)
        else:
            for r0, r1 in self.chunks(full.element_size()):
                phi_c = self.phi_rows(full, r0, r1)
                _gh._ham_chunk(acc, phi_c, full[r0:r1], c1, C2, pm, r0, r1)
                del phi_c
        return reduce_scatter(acc, self.axis).reshape(-1)

    def rdm_grams(self, full):
        """(gamma_flat, corr) partial grams of this rank's rows, f64,
        streamed in sub-chunks."""
        n2 = self.gm.n2
        gamma = full.new_zeros(n2, dtype=torch.float64)
        corr = full.new_zeros((n2, n2), dtype=torch.float64)
        for r0, r1 in self.chunks(full.element_size()):
            phi_c = self.phi_rows(full, r0, r1).reshape(n2, -1)
            gamma += gram_last(phi_c, full[r0:r1].reshape(-1).conj()).real
            corr += gram_last(phi_c.conj(), phi_c).real
            del phi_c
        return gamma, corr


def row_sharded_sector_fns(pqc, mesh, axis="tp", dtype=torch.float64):
    """The row-sharded engine of a string-grid sector circuit on the
    ``axis`` of ``mesh`` (a DeviceMesh).

    ``dtype`` is the engine's compute type: torch.float64 (default) for
    the built-in real ansatze, torch.complex128 for complex sector states
    (the RDMs are float64 for any state); a complex psi into a real
    engine raises TypeError.

    Returns a dict of functions over CANONICAL-order statevectors (as
    ``pqc.state`` returns them), each called by every rank of the axis
    with the same whole inputs:

      rdms(psi)                  -> (gamma, Gamma)
      ham_apply(c1eff, c2, psi)  -> H|psi> (canonical order)
      energy(c0, c1eff, c2, psi) -> E = c0 + Re<psi|H|psi>

    and, with the circuit's grid gate program, GRID-order / theta
    entry points:

      rdms_grid(psi_g)                        -> (gamma, Gamma)
      state(theta)                            -> canonical |psi(theta)>
      energy_gradient(c0, c1eff, c2, theta)   -> (E, dE/dtheta)
      energy_gradient_psi(...)                -> (E, dE/dtheta, psi_g)

    Every output is whole on every rank."""
    gm = pqc.sector_maps
    if not isinstance(gm, GridMaps):
        raise ValueError("row_sharded_sector_fns needs a string-grid "
                         "sector circuit (sector=True)")
    ax = Axis(mesh, axis)
    sh = RowShard(gm, ax)
    ncas = pqc.ncas
    complex_engine = dtype.is_complex

    def chk(psi):
        # a complex state through a real engine would be silently cut to
        # its real part: refuse instead
        psi = torch.as_tensor(psi, device=gm.device)
        if psi.is_complex() and not complex_engine:
            raise TypeError("complex statevector into a real row-sharded "
                            "engine; build row_sharded_sector_fns(..., "
                            "dtype=torch.complex128)")
        return psi.to(dtype)

    def rdms_grid(psi_g):
        gamma, corr = sh.rdm_grams(sh.whole(chk(psi_g)))
        return _grid.assemble_rdms(all_reduce(gamma, ax),
                                   all_reduce(corr, ax), ncas)

    def ham_grid(c1eff, c2, psi_g):
        return sh.flat(sh.gather(sh.ham(c1eff, c2, sh.whole(psi_g))))

    def ham_apply(c1eff, c2, psi):
        return _grid.from_grid(
            ham_grid(c1eff, c2, _grid.to_grid(chk(psi), gm)), gm)

    def energy(c0, c1eff, c2, psi):
        psi = chk(psi)
        hpsi = ham_apply(c1eff, c2, psi)
        return c0 + (psi.conj() @ hpsi).real

    fns = {"rdms": lambda psi: rdms_grid(_grid.to_grid(chk(psi), gm)),
           "rdms_grid": rdms_grid, "ham_apply": ham_apply,
           "energy": energy}

    if getattr(pqc, "grid_program", None) is not None:
        def energy_gradient_psi(c0, c1eff, c2, theta):
            """One row-sharded H-apply of the state, then the circuit
            gradient as one adjoint reverse sweep with the cotangent
            w = 2 H psi (E is quadratic in psi, H independent of theta)."""
            theta = pqc._as_theta(theta)
            psi_g = pqc._state_impl_grid(theta)
            hpsi = ham_grid(c1eff, c2, psi_g.to(dtype)).to(psi_g.dtype)
            e0 = c0 + (psi_g.conj() @ hpsi).real
            zero = psi_g.new_zeros(()).expand(psi_g.shape)
            grad = pqc._pair_row_grid(theta, torch.zeros_like(theta),
                                      2.0 * hpsi, zero, psi_g, zero)
            return e0, grad, psi_g

        fns["energy_gradient_psi"] = energy_gradient_psi
        fns["energy_gradient"] = (
            lambda c0, c1eff, c2, theta:
            energy_gradient_psi(c0, c1eff, c2, theta)[:2])
        fns["state"] = pqc.state
    return fns


def row_sharded_gradient_optimization(oo, mesh, axis="tp", theta_init=None,
                                      **kwargs):
    """``OO_pqc.gradient_optimization`` with every large-D stage on the
    mesh: the Hamiltonian apply, the circuit gradient's cotangent and the
    RDM extraction run row-sharded (``row_sharded_sector_fns``); the loop
    itself is ``gradient_optimization``, driven through its ``eval_fn``
    hook.  The orbital relaxation's RDMs reuse the grid-order state of
    the gradient.  Takes gradient_optimization's keywords; returns
    (energy_l, theta)."""
    from ..ops import hamiltonian as _ham

    eng = row_sharded_sector_fns(oo.pqc, mesh, axis)
    if "energy_gradient_psi" not in eng:
        raise ValueError("row-sharded gradient optimization needs a grid "
                         "gate program (sector=True circuit)")

    def eval_fn(theta):
        c0, c1, c2 = oo.get_active_integrals(oo.mo_coeff)
        e, grad_c, psi_g = eng["energy_gradient_psi"](
            c0, _ham.c1_effective(c1, c2), c2, theta)
        return e, grad_c, (lambda: eng["rdms_grid"](psi_g))

    theta0 = oo.pqc.init_zeros() if theta_init is None else theta_init
    return oo.gradient_optimization(theta0, eval_fn=eval_fn, **kwargs)


def grid2d_nr_fns(oo, mesh, t_axis="tp", r_axis="row"):
    """The 2-D (TANGENT x ROW) quadratic-form Newton engine: the mesh core
    of ``sharded_nr_step_fn`` with the tangent rows on ``t_axis`` and the
    state split by grid rows on ``r_axis``.  Rank (i, j) holds tangent
    block i of the Jacobian on row block j: per tangent chunk one
    reduce_scatter of its full-height H-apply accumulator over the row
    axis; the transition-RDM and circuit grams reduce with all_reduce over
    the row axis and all_gather over the tangent axis.  The gate sweeps,
    the solve and the Fock blocks run whole on every rank.

    Returns ``grad_hess(theta, oao)``, ``energy(theta, kappa, oao)`` (one
    row-sharded H-apply) and ``nr_step(theta, oao, ...)``: the core's
    damped step, whose Armijo trials (t = 1, halved up to 20 times, slack
    64 eps max(1, |e0|), the JAX function's sequence) are row-sharded
    energies.  Needs a string-grid sector circuit with a grid gate
    program."""
    from .sharding import _mesh_core

    pqc = oo.pqc
    gm = getattr(pqc, "sector_maps", None)
    if not isinstance(gm, GridMaps) or pqc.grid_program is None:
        raise ValueError("grid2d_nr_fns needs a string-grid sector circuit "
                         "with a grid gate program (sector=True)")
    core = _mesh_core(oo, mesh, t_axis, r_axis)

    def grad_hess(theta, oao):
        return core["grad_hess"](oo._theta(theta), oao, *oo._mol_args)

    def energy(theta, kappa, oao):
        theta = oo._theta(theta)
        kappa = torch.as_tensor(kappa, dtype=theta.dtype,
                                device=theta.device)
        return core["energy"](theta, kappa, oao, *oo._mol_args)

    def nr_step(theta, oao, alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1,
                lambda_min=1e-6):
        th, kappa, new_oao, e_t, lowest = core["nr_iteration"](
            oo._theta(theta), oao, *oo._mol_args, alpha, beta, mu, rho,
            lambda_min)
        return th, kappa, new_oao, th.new_tensor(e_t), lowest

    return {"grad_hess": grad_hess, "energy": energy, "nr_step": nr_step}
