"""Meshes, the tangent-sharded Newton steps and the geometry batch.

Port of auto_oo_tpu/parallel/sharding.py:

* ``make_mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` over the
  ranks with named axes (one process group per axis); in a single
  process with no group it sets up a one-rank group itself (NCCL on the
  card, gloo on the CPU), so a script runs under plain ``python`` as
  well as under ``torchrun``.
* Hessian-row sharding ("tp"): ``sharded_grad_hess_fn`` and
  ``sharded_nr_step_fn`` run the mesh core of ``OO_pqc``
  (models/oo_pqc.py ``_build_nr_core(mesh=...)``): each rank takes a
  block of the padded tangent rows of the quadratic-form grad+Hessian,
  and an optional ``state_axis`` splits the state axis too; the solve,
  the Armijo search and the MO fold run whole on every rank.
  ``sharded_full_hessian_fn`` is the independent cross-check: the AD
  Hessian of the hybrid energy, rows of the rank's basis vectors by
  ``torch.func.jvp`` of ``torch.func.grad``.
* Geometry batching ("dp"): ``GeometryBatch`` (below).

Every function is called by every rank of the mesh with the same inputs
and returns whole results on every rank.
"""

import torch

from ..models.oo_pqc import (_BATCH_ROUTES, _CHECK_EVERY, _LMAX, OO_pqc,
                             _build_nr_core)
from .distributed import Axis, all_gather, global_mesh

# the trials of the two rounds of ``newton_steps``' line search: t = 1
# for every geometry, then the rest for the geometries still searching
_ROUNDS = (1, _LMAX - 1)


def make_mesh(shape=None, names=("dp", "tp"), device=None):
    """A DeviceMesh over the ranks of the default process group, with axis
    ``names``; ``shape`` None puts every rank on the last axis.  With no
    process group (a single process), a one-rank group of this process
    alone is set up first: NCCL on the card, gloo on the CPU (``device``,
    default the port's device)."""
    return global_mesh(names, shape, device)


def _mesh_core(oo, mesh, axis, state_axis):
    """The mesh core of ``oo``'s circuit (models/oo_pqc.py
    ``_build_nr_core(mesh=...)``).  A sector circuit keeps its string-grid
    kernels with or without a state axis (a grid state splits by blocks
    of grid rows, the row-sharded engine's layout), so the JAX package's
    ``sector_maps`` choice, which switches to flat tables under a state
    axis, has no counterpart here."""
    return _build_nr_core(
        oo.pqc, oo.nao, oo._occ, oo._act, oo.params_idx,
        newton_method=oo.newton_method, mesh=mesh, tangent_axis=axis,
        state_axis=state_axis)


def sharded_full_hessian_fn(oo, mesh, axis="tp"):
    """(theta, oao_mo_coeff) -> the full AD Hessian of the hybrid energy,
    its rows split over ``axis``: each rank takes its block of the basis
    vectors (padded to a multiple of the axis size) through
    ``torch.func.jvp`` of ``torch.func.grad`` of the core's energy, and
    the rows are all-gathered.  The independent cross-check of the
    quadratic-form core; the flat route (a full-space circuit), whose
    E_pq maps are plain indexing."""
    if oo._core["route"] != "flat":
        raise ValueError("sharded_full_hessian_fn differentiates the flat "
                         "route's energy (a full-space circuit); the grid "
                         "kernels have no forward-mode rule")
    ax = Axis(mesh, axis)
    nt, nk = oo._nt, oo.n_kappa
    n = nt + nk
    per, (lo, hi) = ax.block(n)
    energy = oo._core["energy"]

    def full_hessian(theta, oao_mo_coeff):
        th = oo._theta(theta)
        flat0 = torch.cat([th, th.new_zeros(nk)])

        def energy_flat(flat):
            return energy(flat[:nt], flat[nt:], oao_mo_coeff,
                          *oo._mol_args)

        basis = torch.eye(per * ax.size, n, dtype=flat0.dtype,
                          device=flat0.device)[lo:hi]
        # one plain call first: the index tensors the energy caches
        # (utils.misc.index_tensor) must not be made inside a transform,
        # whose levels they would outlive
        energy_flat(flat0)
        hvp = torch.func.grad(energy_flat)
        rows = torch.stack([torch.func.jvp(hvp, (flat0,), (v,))[1]
                            for v in basis])
        return all_gather(rows, ax)[:n]

    return full_hessian


def sharded_grad_hess_fn(oo, mesh, axis="tp", state_axis=None):
    """(theta, oao) -> (energy, gradient, Hessian): the quadratic-form
    core (``OO_pqc._grad_hess``) with the tangent rows split over ``axis``
    and the state axis over ``state_axis`` where given (a second mesh
    axis; the same axis stays with the tangents)."""
    core = _mesh_core(oo, mesh, axis, state_axis)

    def run(theta, oao):
        return core["grad_hess"](oo._theta(theta), oao, *oo._mol_args)

    return run


def sharded_nr_step_fn(oo, mesh, axis="tp", state_axis=None, alpha=1e-4,
                       beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6):
    """One damped Newton step on the mesh core: the split grad+Hessian,
    then the whole augmented solve, the Armijo search (its trial energies
    state-split under a ``state_axis``) and the MO update on every rank.
    Returns (theta, oao) -> (new_theta, new_kappa, new_oao, energy,
    lowest_eig), the values of the single-device
    ``OO_pqc._nr_iteration``."""
    core = _mesh_core(oo, mesh, axis, state_axis)

    def run(theta, oao):
        return core["nr_iteration"](oo._theta(theta), oao, *oo._mol_args,
                                    alpha, beta, mu, rho, lambda_min)

    return run


class GeometryBatch:
    """Stacked-geometry evaluation and optimization (the dp axis): one
    functional, many molecules, the scaling axis of PES scans and
    Berry-phase loops (the JAX package's BASELINE.json config 5).

    Port of ``GeometryBatch`` of auto_oo_tpu/parallel/sharding.py:197-377.
    The JAX package vmaps its per-geometry programs over the stacked
    integrals; here every geometry is a lane of the batched core of
    ``OO_pqc`` (models/oo_pqc.py ``_build_nr_core``): one sweep carries
    every lane's state and tangents, and the lanes fold into the leading
    batch of the grid kernels as far as the Phi budget of one launch
    (``_CHUNK_ELEMENTS``) allows.

    Every geometry shares the circuit, the active space and the frozen
    rotations (``occ``, ``act``, ``params_idx`` of the first geometry), as
    in the JAX package.  The batch runs on the routes of the JAX
    GeometryBatch program ("flat", "fused", "staged"); on the streamed and
    hosted routes, where one Phi already exceeds its block per geometry,
    the constructor raises ValueError.

    With ``mesh`` (a DeviceMesh) the geometries are split over its
    ``axis``: rank r of n takes lanes [r B // n, (r + 1) B // n) (B >= n),
    keeps only their stacked integrals, runs them through the batched
    core, and every result is all-gathered in geometry order, so every
    rank returns every geometry's values."""

    def __init__(self, mols, ncas, nelecas, pqc, mesh=None, axis="dp",
                 freeze_active=True):
        self.oo_list = [OO_pqc(pqc, m, ncas, nelecas,
                               freeze_active=freeze_active) for m in mols]
        self.pqc = pqc
        oo0 = self.oo_list[0]
        self.oo0 = oo0
        self.mesh = mesh
        self.axis = axis
        B = len(self.oo_list)
        self._ax = None
        self._lanes = slice(0, B)
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a torch.distributed "
                                f"DeviceMesh (parallel.make_mesh), got "
                                f"{type(mesh).__name__}")
            self._ax = Axis(mesh, axis)
            n, r = self._ax.size, self._ax.rank
            if B < n:
                raise ValueError(f"{B} geometries over the {n} ranks of "
                                 f"axis {axis!r}: each rank needs one")
            self._bounds = [(k * B // n, (k + 1) * B // n)
                            for k in range(n)]
            self._lanes = slice(*self._bounds[r])
        route = oo0._core["route"]
        if route not in _BATCH_ROUTES:
            raise ValueError(
                f"GeometryBatch runs on the {', '.join(_BATCH_ROUTES)} "
                f"routes; this circuit takes the {route} route (D = "
                f"{pqc.state_dim}), where one Phi already exceeds its "
                "block per geometry")
        # one core serves every geometry: its molecule arrays are
        # arguments; this rank's lanes only
        self._core = oo0._core
        mine = self.oo_list[self._lanes]
        self.int1e = torch.stack([oo.int1e_ao for oo in mine])
        self.int2e = torch.stack([oo.int2e_ao for oo in mine])
        self.oao_c = torch.stack([oo.oao_coeff for oo in mine])
        self.nuc = torch.tensor([oo.nuc for oo in mine],
                                dtype=self.int1e.dtype, device=pqc.device)

    def _gather(self, out):
        """Every rank's lanes of ``out`` (this rank's lanes first), in
        geometry order; ``out`` itself without a mesh."""
        if self._ax is None:
            return out
        per = max(hi - lo for lo, hi in self._bounds)
        pad = per - out.shape[0]
        if pad:
            out = torch.cat([out, out.new_zeros((pad,) + out.shape[1:])])
        full = all_gather(out, self._ax)
        return torch.cat([full[k * per:k * per + hi - lo]
                          for k, (lo, hi) in enumerate(self._bounds)])

    def _run(self, fn, *lane_args, **kw):
        """fn(this rank's lanes of lane_args, stacked integrals, **kw),
        each of its outputs gathered over the geometries."""
        out = fn(*(a[self._lanes] for a in lane_args), *self._args, **kw)
        if isinstance(out, tuple):
            return tuple(self._gather(o) for o in out)
        return self._gather(out)

    @property
    def _args(self):
        return self.int1e, self.int2e, self.oao_c, self.nuc

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.int1e.dtype,
                               device=self.pqc.device)

    def _starts(self, theta0, oao_mo0):
        """(thetas (B, nt), oaos (B, nao, nao)) from a shared or
        per-geometry start; the OAO coefficients default to each
        geometry's own."""
        B = len(self.oo_list)
        theta0 = self._tensor(theta0)
        if theta0.dim() == 1:
            theta0 = theta0.expand(B, -1)
        if oao_mo0 is None:
            oao_mo0 = torch.stack([oo.oao_mo_coeff for oo in self.oo_list])
        else:
            oao_mo0 = self._tensor(oao_mo0)
            if oao_mo0.dim() == 2:
                oao_mo0 = oao_mo0.expand(B, -1, -1)
        return theta0.contiguous(), oao_mo0.contiguous()

    def energies(self, thetas, kappas, oao_mos):
        """Batched E(theta_i, kappa_i) over all geometries at once: (B,)."""
        return self._run(self._core["energy_batch"], self._tensor(thetas),
                         self._tensor(kappas), self._tensor(oao_mos))

    def gradients(self, thetas, kappas, oao_mos):
        """Batched (dE/dtheta (B, nt), dE/dkappa (B, n_kappa)), by
        autograd through the batched energy (the grid kernels are
        autograd Functions)."""
        def grads(thetas, kappas, oao_mos, *args):
            with torch.enable_grad():
                th = thetas.detach().requires_grad_(True)
                ka = kappas.detach().requires_grad_(True)
                e = self._core["energy_batch"](th, ka, oao_mos, *args)
                return tuple(torch.autograd.grad(e.sum(), (th, ka)))

        return self._run(grads, self._tensor(thetas), self._tensor(kappas),
                         self._tensor(oao_mos))

    def newton_steps(self, thetas, oao_mos, alpha=1e-4, beta=0.5, mu=1e-6,
                     rho=1.1, lambda_min=1e-6):
        """ONE damped Newton step on EVERY geometry concurrently: the
        grad+Hessian, augmented solve, Armijo search and MO fold of the
        sequential ``OO_pqc._nr_iteration``, with the geometries as lanes
        of the batched core.  The line search takes two rounds (t = 1 for
        every geometry, then the other 19 trials for those still
        searching), one host read between them.  Returns (new_thetas,
        new_kappas, new_oao_mos, energies, lowest_eigs), each with a
        leading geometry axis."""
        thetas, oao_mos = self._starts(thetas, oao_mos)
        return self._step(thetas, oao_mos, alpha, beta, mu, rho,
                          lambda_min, _ROUNDS)

    def _step(self, thetas, oaos, alpha, beta, mu, rho, lambda_min,
              rounds=None):
        return self._run(self._core["nr_iteration_batch"], thetas, oaos,
                         alpha=alpha, beta=beta, mu=mu, rho=rho,
                         lambda_min=lambda_min, rounds=rounds)

    def optimize(self, theta0, oao_mo0=None, n_steps=10, **nr_kwargs):
        """``n_steps`` batched Newton steps from a shared or per-geometry
        start; returns the trajectory of batched energies (a list of (B,)
        tensors) and the final (thetas, oao_mos, lowest_eigs).  The PES
        scan / Berry-loop tracking driver: all geometries advance
        together, step by step."""
        thetas, oaos = self._starts(theta0, oao_mo0)
        energy_hist = []
        lowest = None
        for _ in range(n_steps):
            thetas, _kappas, oaos, energies, lowest = self.newton_steps(
                thetas, oaos, **nr_kwargs)
            energy_hist.append(energies)
        return energy_hist, thetas, oaos, lowest

    def optimize_device_loop(self, theta0, oao_mo0=None, max_steps=50,
                             conv_tol=1e-10, alpha=1e-4, beta=0.5, mu=1e-6,
                             rho=1.1, lambda_min=1e-6):
        """Batched optimization to convergence with no host read in a
        step: each step's line search is one round of all lmax trials
        decided on the device, and the test of the JAX package's
        ``optimize_device_loop`` (stop once n >= 3 steps ran and every
        geometry's |dE| < conv_tol, or at ``max_steps``) is a device flag
        the host reads once every few steps; steps past it are thrown
        away.  Returns (energy_hist [n_done, B], thetas, oao_mos,
        lowest_eigs)."""
        thetas, oaos = self._starts(theta0, oao_mo0)
        B = thetas.shape[0]
        hist = thetas.new_zeros((int(max_steps), B))
        lowest = thetas.new_zeros(B)
        done = torch.zeros((), dtype=torch.bool, device=thetas.device)
        n_done = torch.zeros((), dtype=torch.int64, device=thetas.device)
        e1 = e2 = None
        for n in range(int(max_steps)):
            th2, _kap, oa2, e_t, low = self._step(
                thetas, oaos, alpha, beta, mu, rho, lambda_min)
            live = ~done
            hist[n] = e_t
            thetas = torch.where(live, th2, thetas)
            oaos = torch.where(live, oa2, oaos)
            lowest = torch.where(live, low, lowest)
            n_done = n_done + live.long()
            e2, e1 = e1, (e_t if e1 is None else torch.where(live, e_t, e1))
            if n >= 2:
                # the JAX condition after step n + 1: n + 1 >= 3 and every
                # |e_{n} - e_{n-1}| < conv_tol
                done = done | (live & ((e1 - e2).abs() < conv_tol).all())
            if ((n + 1) % _CHECK_EVERY == 0 and n + 1 < int(max_steps)
                    and bool(done)):
                break
        n = int(n_done)
        return hist[:n], thetas, oaos, lowest
