"""OO_pqc: hybrid circuit + orbital cost with exact gradients/Hessians.

Port of auto_oo_tpu/models/oo_pqc.py (reference oo_pqc.py:30-207).  The
cost is
E(theta, kappa) = c0 + sum h~ gamma(theta) + sum g Gamma(theta) with MOs
rotated by expm(-kappa).  One ``grad_hess`` call gives every derivative
block:

* circuit gradient / circuit-circuit Hessian: the quadratic form
  2 J (H psi) / 2 J H J^T + d2<w, psi(theta)> with w = 2 H psi, where
  (psi, J) come from one tangent-batched sweep of the circuit's gate
  program and d2<w, psi> from one reverse sweep (simulator/program.py),
  and H applies through the circuit's E_pq maps (ops/hamiltonian.py);
* orbital gradient / orbital-orbital Hessian: closed-form generalized-Fock
  expressions (ops/fock.py);
* mixed block: the affine analytic-gradient map applied to the transition
  RDMs built from J and the Phi gram.

``full_optimization`` runs damped-Newton iterations from a host loop: one
``grad_hess``, then the augmented solve (eigh, or with
``newton_method="iterative"`` the eigh-free ``ops/linalg.
newton_dir_iterative``), an Armijo line search with one scalar sync per
trial, and the fold of kappa into the OAO coefficients.  With
``device_loop=True`` (the JAX package's ``full_opt_loop``) the same
iterations run with no host read in their body: all lmax Armijo trials
in one batched energy call, the first accepted one picked on the
device, the convergence flag read once every ``_CHECK_EVERY``
iterations, the trajectory in device buffers fetched once.

The core has batched forms (``energy_batch``, ``grad_hess_batch``,
``newton_update_batch``, ``nr_iteration_batch``) over a leading lane
axis, on the routes of the JAX GeometryBatch program ("flat", "fused",
"staged"): the geometries of ``parallel.GeometryBatch``, the trials of
a line search, the one run of a device loop.  Every lane has its own
integrals, OAO coefficients and parameters; one sweep carries all lanes,
the grid kernels take several lanes in one launch, and the contractions
over the state axis and the orbital algebra run per lane on one lane's
shapes.  The f64 ``grad_hess`` on these routes is ``grad_hess_batch``
of one lane, so a lane's step is the sequential one up to the batch
sizes of the sweeps and the folded launches.

A full-space circuit (``sector=False``) takes the "flat" route: the same
``grad_hess`` on the flat gate program and the flat E_pq maps, in the
canonical basis order.  It holds one (n^2, D) Phi, as the JAX
package's flat route does (33.5 MB at (8e,8o)).  A callable ansatz (real
or complex) and an up-then-down circuit take it too: the circuit's
sweeps then come from ``torch.func`` over the callable
(simulator/custom.py), its maps are the up-then-down ones, and every
inner product conjugates its bra side and takes the real part, as in the
JAX core (auto_oo_tpu/models/oo_pqc.py:233-237, 262-272, 323-361).  A
sector circuit runs on the string grid, by the rules below.

Above D = 2^19 the JAX package splits the same math into its staged
pipeline, only so that one XLA program does not spill; ``grad_hess`` here
is already an eager host loop over tangent chunks, so it runs both the
JAX package's fused and staged regimes as it is.  Where one (n^2, D) f64
Phi exceeds its 1 GB block ((14e,14o) on), the route is "streamed": the
same ``grad_hess`` takes every H-apply, RDM and transition-RDM row
through the row-streamed grid functions (ops/grid.py), one tangent at a
time, with sizes chosen once from the free device memory
(``grid.stream_plan``).  Where one full-Phi pass reaches the JAX
package's hosting threshold ((16e,16o) on), the route is "hosted": the
(n_theta, D) stacks of J and H J no longer fit beside the Phi chunks, so
``grad_hess`` takes one of the JAX package's two hosted forms, chosen by
its rule: where
the (n_theta + 1, D) stack of psi and its tangent columns fits
``grid_hosted._HOSTED_STACK_MAX_BYTES`` the "gram" form
(``grad_hess_hosted_gram``): the n_theta pair sweeps fill the stack, one
multi-state sweep over its Phi chunks (``grid_hosted.cross_hosted``)
gives e0, the gradient, the quadratic term of the Hessian and every RDM
gram, then one hosted H-apply of psi seeds one reverse pair sweep per
Hessian row; else the "per_tangent" form (``grad_hess_hosted``): one
pass over Phi for (H psi, RDMs), then per tangent one pair sweep for
J_i, one scatter-form H-apply (with the transition RDMs when n_kappa >
0) and one reverse pair sweep for the Hessian row (ops/grid_hosted.py,
simulator/grid_program.py).  The energy takes its RDMs from one hosted
pass.

``precision="mixed"`` is the JAX package's mixed mode
(auto_oo_tpu/models/oo_pqc.py:62-140): the Hessian blocks (J, H J, the
circuit-Hessian sweep, the grams, the transition RDMs) run in float32
on every route, energy, gradient, psi's RDMs and every Fock pack stay
float64, and the Hessian is float64 for the solve.  On the hosted route
the passes over Phi run on the float32 state, so e0 and the gradient
carry float32-level error there, and the Armijo comparison takes the
JAX package's hosted-mixed slack.  Float32 matmuls run at full float32
precision (config.py); the sums over the state axis are
``linalg.gram_last``'s.

The gradient-only pipeline (``energy_and_gradient``,
``gradient_optimization``) is the JAX package's first-order OO-VQE for
the scales where no Hessian fits: per step the state, one H-apply, one
adjoint reverse sweep for the circuit gradient and the RDMs for the
orbital one (``energy_gradient_staged``, on every route, in both
precisions), Adam on theta in optax's order (utils/optim.py), and every
``orbital_every`` steps a damped-Newton orbital relaxation at fixed RDMs
(``OO_energy.orbital_optimization``).
"""

import contextlib
import time

import numpy as np
import torch

from ..ops import fock as _fock
from ..ops import grid as _grid
from ..ops import grid_hosted as _gh
from ..ops import hamiltonian as _ham
from ..ops import kappa as _kappa
from ..ops import rdms as _rdms
from ..ops import transforms as _tr
from ..ops.linalg import expm, gram_last
from ..utils import optim as _optim
from ..utils.misc import index_tensor
from ..utils.newton_raphson import (backtracking_batched,
                                    damped_newton_step_pure,
                                    newton_step_pure)
from .oo_energy import OO_energy

# from this sector dimension on the JAX package runs its staged pipeline
# (auto_oo_tpu/models/oo_pqc.py:1025-1027), the same math as its fused
# programs; the port runs both with the same eager code
_STAGED_MIN_D = 1 << 19

# tangent chunks keep the (chunk, n^2, D) Phi/Y intermediates ~256 MB
_CHUNK_ELEMENTS = 1 << 25

# D-vectors the hosted grad_hess keeps beside its Phi chunks: psi, H psi,
# one J_i, one H J_i, and the reverse pair sweep's four grids with their
# out-of-place temporaries
_HOSTED_RESIDENT_VECTORS = 10

_PRECISIONS = ("f64", "mixed")

# the routes with a geometry batch (the JAX GeometryBatch program's); on
# the streamed and hosted routes one Phi already exceeds its block per
# geometry
_BATCH_ROUTES = ("flat", "fused", "staged")

# the trials of one Armijo search (the JAX package's lmax)
_LMAX = 20

# the device loop reads its convergence flag once every this many
# iterations; the iterations run past convergence inside a window repeat
# the converged one and are thrown away
_CHECK_EVERY = 4
_HOSTED_FORMS = ("gram", "per_tangent")

# the Armijo slack of the hosted mixed route, relative to max(1, |e0|):
# its trial energies come from float32 passes (~1e-6 relative noise), so
# the roundoff slack would burn every halving on precision
# (auto_oo_tpu/models/oo_pqc.py:1057-1061)
_HOSTED_MIXED_SLACK = 2e-6


def _route(pqc, streamed=False):
    """"flat" for a full-space circuit; on a sector, the JAX package's
    route: "fused", "staged", "streamed" or "hosted" (``streamed`` forces
    the streamed route below the hosting threshold,
    ops/grid_hosted.needs_hosting)."""
    D, n2 = pqc.state_dim, pqc.ncas * pqc.ncas
    if pqc.grid_program is None:
        return "flat"
    if _gh.needs_hosting(pqc.sector_maps):
        return "hosted"
    if streamed or _grid._pair_chunk(1, D, n2, 8) < n2:
        return "streamed"
    return "staged" if D >= _STAGED_MIN_D else "fused"


class _Parts:
    """Host-clock seconds and peak device memory of the parts of a
    grad_hess, summed by label over a call, while ``enabled`` (the
    profile scripts): each part starts and ends in a synchronize.  Off, a
    part is a bare ``with`` block."""

    def __init__(self, device):
        self.device = device
        self.enabled = False
        self.seconds = {}
        self.peaks = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, label):
        if not self.enabled:
            yield
            return
        self._sync()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[label] = (self.seconds.get(label, 0.0)
                               + time.perf_counter() - t0)
        if cuda:
            self.peaks[label] = max(self.peaks.get(label, 0),
                                    torch.cuda.max_memory_allocated(
                                        self.device))


def _build_nr_core(pqc, nao, occ, act, params_idx, stream_plan=None,
                   precision="f64", hosted_form=None, newton_method=None,
                   mesh=None, tangent_axis="tp", state_axis=None):
    """Geometry-independent functional core for one problem spec: the
    molecule arrays (int1e_ao, int2e_ao, oao_coeff, nuc) are arguments of
    every function, so one core serves every geometry.  ``hosted_form``
    ("gram" or "per_tangent") forces the hosted route's form; by default
    it follows the JAX package's rule (``grid_hosted.gram_fits``).
    ``newton_method`` is the Newton solve of ``newton_update``
    (utils/newton_raphson.newton_step_pure).

    With ``mesh`` (a torch DeviceMesh) ``grad_hess`` is the JAX package's
    mesh core (auto_oo_tpu/models/oo_pqc.py:98-175, 270-300) in f64 on
    the flat, fused and staged routes: each rank of ``tangent_axis`` takes
    its block of the padded tangent rows (H J, transition RDMs, gradient
    pieces), and ``state_axis``, a second axis, splits the state axis of
    J, Phi and H J (parallel/statevector.state_shard: grid rows on a
    sector, basis blocks in the full space).  When both name one axis the
    tangent axis keeps it.  The gate sweeps, the Newton solve, the Armijo
    search and the MO fold run whole on every rank; with a state axis the
    Armijo trials' energies run state-split too (``_mesh_core``).  The
    mesh core returns only its sharded functions."""
    route = _route(pqc, streamed=stream_plan is not None)
    if mesh is not None and (route not in _BATCH_ROUTES
                             or precision != "f64"):
        raise ValueError(f"the mesh core runs in f64 on the "
                         f"{', '.join(_BATCH_ROUTES)} routes, not "
                         f"{precision} on the {route} route")
    params_idx = tuple(int(i) for i in params_idx)
    params_idx_dev = torch.as_tensor(np.asarray(params_idx, dtype=np.int64),
                                     device=pqc.device)
    n_kappa = len(params_idx)
    tril_size = nao * (nao - 1) // 2
    nt = int(pqc.theta_shape)
    ncas = pqc.ncas
    n2 = ncas * ncas
    D = pqc.state_dim
    maps = pqc.epq_maps
    streamed = route == "streamed"
    hosted = route == "hosted"
    # mixed precision: the Hessian-only work runs in float32 (lp); the
    # route is chosen on the f64 itemsize in both modes, as in the JAX
    # package (oo_pqc.py:937-943)
    mixed = precision == "mixed"
    lp_size = 4 if mixed else 8

    def lp(x):
        """The low-precision copy: float32 (complex64) in mixed mode, as
        the JAX package's _lowp (oo_pqc.py:60-73); x itself in f64."""
        if not mixed:
            return x
        return x.to(torch.complex64 if x.is_complex() else torch.float32)

    if hosted_form is not None and not hosted:
        raise ValueError(f"hosted_form={hosted_form!r} on the {route} "
                         "route: only the hosted route has forms")
    form = None
    if hosted:
        form = hosted_form or ("gram" if _gh.gram_fits(nt, D, lp_size)
                               else "per_tangent")
    gram = form == "gram"
    parts = _Parts(pqc.device)
    # plan sizes the passes over f64 states, plan_lp those over the
    # Hessian's lp states (the JAX package's f32 rows take 4-byte items,
    # oo_pqc.py:594-595); one given stream_plan sizes both
    plan = plan_lp = cross_rows = None
    if streamed or hosted:
        # the streamed grad_hess keeps psi, J, H psi, w and the H J rows
        # resident beside the Phi chunks and Y blocks; the hosted one O(D)
        vectors = _HOSTED_RESIDENT_VECTORS if hosted else 2 * nt + 4
        resident = vectors * D * 8
        plan = stream_plan or _grid.stream_plan(maps, 1, 8, resident)
        plan_lp = (stream_plan or _grid.stream_plan(maps, 1, 4, resident)
                   if mixed else plan)
        budget = ("" if plan.budget is None
                  else f", {plan.budget / 1e9:.1f} GB budget")
        if hosted:
            # the per-tangent pass with n_kappa > 0 builds two Phi chunks
            pair_rows = _grid._even(maps.Na, plan_lp.row_chunk // 2)
            extra = ""
            if gram:
                # the cross sweep runs beside the (nt + 1, D) stack
                cross_rows = (stream_plan.row_chunk if stream_plan else
                              _gh.cross_plan(maps, nt + 1, lp_size,
                                             resident + (nt + 1) * D
                                             * lp_size))
                extra = (f"; cross sweep row chunk {cross_rows} for "
                         f"{nt + 1} states")
            print(f"OO_pqc: hosted route ({form} form, {precision}), row "
                  f"chunk {plan_lp.row_chunk} of {maps.Na} grid rows "
                  f"({pair_rows} where a pass builds two Phi chunks)"
                  f"{extra}{budget}", flush=True)
        else:
            lp_rows = (f" ({plan_lp.row_chunk} and {plan_lp.pair_block} "
                       f"for the f32 Hessian rows)" if mixed else "")
            print(f"OO_pqc: streamed route, row chunk {plan.row_chunk} of "
                  f"{maps.Na} grid rows, pair block {plan.pair_block} of "
                  f"{n2} pairs{lp_rows}{budget}", flush=True)

    def k2m(kappa):
        if kappa.dim() > 1:
            total = kappa.new_zeros(kappa.shape[:-1] + (tril_size,))
            total = total.index_copy(-1, params_idx_dev, kappa)
            return _kappa.vector_to_skew_symmetric(total, nao)
        total = torch.zeros(tril_size, dtype=kappa.dtype,
                            device=kappa.device)
        total = total.index_put((params_idx_dev,), kappa)
        return _kappa.vector_to_skew_symmetric(total, nao)

    # the energy needs integrals with ALL indices in occ+act, so the
    # 4-index transform runs with the (nao, ns) sub-coefficients
    sub = index_tensor(tuple(occ) + tuple(act), pqc.device)
    occ_rel = tuple(range(len(occ)))
    act_rel = tuple(range(len(occ), len(occ) + len(act)))

    def sub_coefficients(kappa, oao, int1e_ao, int2e_ao, oao_coeff, nuc):
        """(c0, c1, c2) of the active-space Hamiltonian at the MOs
        oao_coeff @ oao @ exp(-K(kappa)), from the occ+act integrals."""
        mo = oao_coeff @ oao @ expm(-k2m(kappa))
        mo_sub = mo.index_select(-1, sub)
        h1 = _tr.int1e_transform(int1e_ao, mo_sub)
        g2 = _tr.int2e_transform(int2e_ao, mo_sub)
        return _tr.molecular_hamiltonian_coefficients(nuc, h1, g2, occ_rel,
                                                      act_rel)

    def energy(theta, kappa, oao, int1e_ao, int2e_ao, oao_coeff, nuc):
        c0, c1, c2 = sub_coefficients(kappa, oao, int1e_ao, int2e_ao,
                                      oao_coeff, nuc)
        psi = pqc._state_impl_grid(theta)
        if hosted:
            # mixed: the hosted RDM pass on the f32 state (the JAX
            # package's energy_hosted); f64 accumulators
            one_rdm, two_rdm = _gh.rdms_hosted(lp(psi), maps, ncas,
                                               plan_lp.row_chunk)
        else:
            one_rdm, two_rdm = _rdms.rdms_from_state(
                psi, ncas, maps, grid_order=True, plan=plan)
        return _tr.energy_from_rdms(c0, c1, c2, one_rdm, two_rdm)

    def _grid_or_flat_sum(Y):
        """sum_pq E_pq Y[..., pq, :] over the route's maps (``ham_apply``'s
        reduction)."""
        if isinstance(maps, _rdms.FlatMaps):
            return _rdms.epq_sum_flat(Y, maps)
        return _grid.epq_sum(Y, maps)

    def pack_grad(h1, g2, g1, G2):
        """Packed analytic orbital gradient; batch dims of the RDMs are
        kept (one row per circuit tangent in the mixed block)."""
        grad4 = _fock.analytic_gradient_from_integrals(h1, g2, g1, G2, occ,
                                                       act)
        return _kappa.skew_symmetric_to_vector(grad4)[..., params_idx_dev]

    def trdm_blocks(dgamma, dgram):
        """(dgamma, dGamma) of a batch of tangents from the flat transition
        grams (the pair order of grid.transition_rdms_rows); f64."""
        dgamma = dgamma.reshape(-1, ncas, ncas)
        dcorr = dgram.reshape(-1, ncas, ncas, ncas, ncas)
        delta = torch.eye(ncas, dtype=dgamma.dtype, device=dgamma.device)
        dGamma = (dcorr.permute(0, 2, 1, 3, 4)
                  - torch.einsum("qr,ips->ipqrs", delta, dgamma))
        return dgamma, dGamma

    def transition_rdms(phi, psi, Jc, phiJ=None):
        """d(gamma, Gamma)/d theta_i for a chunk of tangents Jc, by the
        product rule on the Phi gram of psi; on the streamed route (no
        phi) one tangent at a time through grid.transition_rdms_rows (the
        JAX package's _row_streamed).  The grams run in the operands'
        dtype (f32 in mixed mode); the blocks are f64.  ``phiJ``, the Phi
        of Jc, is built here unless given.  A complex state's
        bra sides are conjugated and the real parts taken
        (auto_oo_tpu/models/oo_pqc.py:331-345)."""
        if phi is None:
            rows = [_grid.transition_rdms_rows(psi, Ji, maps, ncas,
                                               plan_lp.row_chunk)
                    for Ji in Jc]
            dgamma = torch.stack([r[0] for r in rows])
            dgram = torch.stack([r[1] for r in rows])
        else:
            if phiJ is None:
                phiJ = _rdms.apply_epq_all(Jc, ncas, maps)   # (c, n^2, D)
            # d corr[a,b] = Re <dphi_a|phi_b> + Re <phi_a|dphi_b>
            A = gram_last(phiJ.conj(), phi).real
            dgram = A + A.transpose(1, 2)
            dgamma = (gram_last(phiJ, psi.conj()).real
                      + gram_last(phi, Jc.conj()).real.T)
        return trdm_blocks(dgamma, dgram)

    def coefficients(oao, int1e_ao, int2e_ao, oao_coeff, nuc):
        """(h1, g2, c0, c1eff, c2) of the active-space Hamiltonian at the
        MOs oao_coeff @ oao."""
        mo = oao_coeff @ oao
        h1 = _tr.int1e_transform(int1e_ao, mo)
        g2 = _tr.int2e_transform(int2e_ao, mo)
        c0, c1, c2 = _tr.molecular_hamiltonian_coefficients(
            nuc, h1, g2, occ, act)
        return h1, g2, c0, _ham.c1_effective(c1, c2), c2

    def assemble(h1, g2, gamma, Gamma, grad_c, hess_cc, trdms):
        """(grad, hess) from the circuit blocks, psi's RDMs and the
        tangents' transition RDMs ``trdms``, an iterable of (dgamma,
        dGamma) batches in tangent order, read only when n_kappa > 0."""
        grad_o = pack_grad(h1, g2, gamma, Gamma)
        if n_kappa:
            # the analytic gradient is affine in the RDMs: subtract its
            # value at zero RDMs to apply the linear part to each tangent
            G0 = pack_grad(h1, g2, torch.zeros_like(gamma),
                           torch.zeros_like(Gamma))
            hess_oc = torch.cat([pack_grad(h1, g2, *tr) - G0
                                 for tr in trdms]).T
        else:
            hess_oc = torch.zeros((0, nt), dtype=grad_c.dtype,
                                  device=grad_c.device)
        hess4 = _fock.analytic_hessian_from_integrals(
            h1, g2, gamma, Gamma, occ, act)
        hess_oo = _fock.full_hessian_to_matrix(hess4, params_idx, nao)
        grad = torch.cat([grad_c, grad_o])
        # mixed: the f32 circuit block joins the f64 blocks as f64, for
        # the solve (the JAX package's hess.astype(f64))
        hess = torch.cat([torch.cat([hess_cc.to(grad.dtype), hess_oc.T],
                                    dim=1),
                          torch.cat([hess_oc, hess_oo], dim=1)])
        return grad, hess

    def unit(th, i):
        v = torch.zeros_like(th)
        v[i] = 1.0
        return v

    def zero_state(like):
        """A zero cotangent (or tangent state) without a D-sized buffer."""
        return like.new_zeros(()).expand(like.shape)

    def energy_grad(theta, psi, Hpsi, c0):
        """e0 = c0 + Re<psi, H psi> and grad_c = d/d theta Re<2 H psi,
        psi(theta)> by one reverse sweep in f64 (the JAX package's
        _grad_c_vjp: pair_row with v = 0 and no delta cotangent), never an
        autograd tape over the gate program; an f32 H psi (mixed) joins the
        f64 state as f64."""
        Hpsi64 = Hpsi.to(psi.dtype)
        e0 = c0 + (psi.conj() @ Hpsi64).real
        grad_c = pqc._pair_row_grid(theta, torch.zeros_like(theta),
                                    2.0 * Hpsi64, zero_state(psi), psi,
                                    zero_state(psi))
        return e0, grad_c

    def hosted_pass(theta, c0, c1eff, c2):
        """The hosted route's gradient pass: the state (and its f32 copy
        in mixed mode), one pass over Phi for H psi and psi's RDMs
        (``grid_hosted.ham_and_rdms_hosted``, the low-precision plan's row
        chunk), then ``energy_grad``.  Returns (psi, psi_p, H psi, gamma,
        Gamma, e0, grad_c)."""
        with parts("state sweep"):
            psi = pqc._state_impl_grid(theta)
            psi_p = lp(psi)
        with parts("(H psi, RDMs) pass"):
            Hpsi, gamma, Gamma = _gh.ham_and_rdms_hosted(
                c1eff, c2, psi_p, maps, ncas, plan_lp.row_chunk)
        with parts("gradient sweep"):
            e0, grad_c = energy_grad(theta, psi, Hpsi, c0)
        return psi, psi_p, Hpsi, gamma, Gamma, e0, grad_c

    def grad_hess_hosted(theta, h1, g2, c0, c1eff, c2):
        """The hosted route's per-tangent form: the JAX package's
        per-tangent hosted branch (auto_oo_tpu/models/oo_pqc.py:770-819).
        ``hosted_pass`` gives psi, H psi, psi's RDMs, e0 and grad_c; then
        per tangent i one pair sweep gives J_i, one pass gives H J_i (with
        the transition RDMs of (psi, J_i) when n_kappa > 0), and one
        reverse pair sweep gives the Hessian row 2 d/d theta [<psi(theta),
        H J_i> + <J(theta) e_i, H psi>].  J and H J are never stacked.
        Mixed: the passes and the pair sweeps run on f32 states and
        theta."""
        pair_rows = _grid._even(maps.Na, plan_lp.row_chunk // 2)
        psi, psi_p, Hpsi, gamma, Gamma, e0, grad_c = hosted_pass(
            theta, c0, c1eff, c2)
        th_p = lp(theta)
        hess_cc = theta.new_empty((nt, nt))
        trdms = []
        for i in range(nt):
            v = unit(th_p, i)
            with parts("pair sweeps (J_i)"):
                Ji = pqc._pair_state_grid(th_p, v)[1]
            with parts("H J_i passes"):
                if n_kappa:
                    HJi, dgamma, dgram = _gh.ham_and_trdms_hosted(
                        c1eff, c2, psi_p, Ji, maps, ncas, pair_rows)
                    trdms.append(trdm_blocks(dgamma, dgram))
                else:
                    HJi = _gh.ham_apply_hosted(c1eff, c2, Ji, maps,
                                               plan_lp.row_chunk)
            with parts("reverse pair sweeps (rows)"):
                hess_cc[i] = 2.0 * pqc._pair_row_grid(th_p, v, HJi, Hpsi,
                                                      psi_p, Ji)
            del Ji, HJi
        grad, hess = assemble(h1, g2, gamma, Gamma, grad_c, hess_cc, trdms)
        return e0, grad, hess

    def grad_hess_gram(theta, h1, g2, c0, c1eff, c2):
        """The hosted route's Gram form: the JAX package's
        grad_hess_hosted_gram (auto_oo_tpu/models/oo_pqc.py:704-761).  The
        pair sweeps write psi and the n_theta tangent columns J_i into one
        (nt + 1, Na, Nb) stack (f32 in mixed mode), one
        ``grid_hosted.cross_hosted`` sweep over it gives <s_a|H|s_b>, so
        e0, grad_c = 2 <J_i|H|psi> and term1 = 2 sym <J_i|H|J_j>, psi's
        RDMs and, when n_kappa > 0, the transition RDMs; the stack is
        freed, one hosted H-apply gives H psi, and one reverse pair sweep
        per tangent gives the term2 row d/d theta <J(theta) e_i, 2 H psi>
        (the JAX package's _t2_row_pair).  No tangent H-apply runs."""
        th_p = lp(theta)
        with parts("state sweep"):
            psi_p = lp(pqc._state_impl_grid(theta))
        S = psi_p.new_empty((nt + 1, maps.Na, maps.Nb))
        S[0] = psi_p.reshape(maps.Na, maps.Nb)
        for i in range(nt):
            with parts("pair sweeps (J_i)"):
                S[i + 1] = pqc._pair_state_grid(th_p, unit(th_p, i))[
                    1].reshape(maps.Na, maps.Nb)
        with parts("cross sweep"):
            M1, gsmall, cross0 = _gh.cross_hosted(
                S, c2, maps, ncas, cross_rows, tangent_grams=n_kappa > 0)
        # the stack goes before the H-apply pass allocates its chunks
        del S
        with parts("H psi pass"):
            Hpsi = _gh.ham_apply_hosted(c1eff, c2, psi_p, maps,
                                        plan_lp.row_chunk)
        ham = M1 + gsmall @ c1eff.reshape(n2).to(M1.dtype)
        e0 = c0 + ham[0, 0]
        grad_c = 2.0 * ham[1:, 0]
        term1 = ham[1:, 1:] + ham[1:, 1:].T
        gamma, Gamma = _grid.assemble_rdms(gsmall[0, 0], cross0[0], ncas)
        trdms = ([trdm_blocks(gsmall[0, 1:] + gsmall[1:, 0],
                              cross0[1:] + cross0[1:].transpose(1, 2))]
                 if n_kappa else [])
        t2 = torch.empty_like(term1)
        for i in range(nt):
            with parts("reverse pair sweeps (rows)"):
                t2[i] = 2.0 * pqc._pair_row_grid(th_p, unit(th_p, i),
                                                 zero_state(psi_p), Hpsi)
        grad, hess = assemble(h1, g2, gamma, Gamma, grad_c, term1 + t2,
                              trdms)
        return e0, grad, hess

    def grad_hess(theta, oao, int1e_ao, int2e_ao, oao_coeff, nuc):
        """Energy, full gradient, full (theta+kappa) Hessian.

        With H the fixed active-space Hamiltonian and J = d psi/d theta:
          grad_c   = 2 Re J^* (H psi)
          hess_cc  = 2 Re J^* (H J^T) + hess_theta Re<w, psi(theta)>,
                     w = 2 H psi
          hess_oc  = analytic-gradient linear map applied to the
                     transition RDMs d(gamma, Gamma)/d theta_i
        Every state here is in the maps' order: GRID order (ops/grid.py)
        on a sector, canonical in the full space.  Every inner product
        conjugates its bra side and takes the real part, so a complex
        state (a callable ansatz's) is exact; both are no-ops on the real
        states of the gate programs.

        In float64 on the flat, fused and staged routes this is
        ``grad_hess_batch`` of one lane; the body below runs the streamed
        route and mixed precision, the hosted route its own forms."""
        if route in _BATCH_ROUTES and not mixed:
            e0, grad, hess = grad_hess_batch(
                theta[None], oao[None], int1e_ao[None], int2e_ao[None],
                oao_coeff[None], (nuc,))
            return e0[0], grad[0], hess[0]
        h1, g2, c0, c1eff, c2 = coefficients(oao, int1e_ao, int2e_ao,
                                             oao_coeff, nuc)
        if hosted:
            return (grad_hess_gram if gram else grad_hess_hosted)(
                theta, h1, g2, c0, c1eff, c2)

        with parts("state + J sweep"):
            psi, J = pqc._state_and_jacobian_grid(theta)   # (D,), (nt, D)
        with parts("H psi"):
            Hpsi = _ham.ham_apply(c1eff, c2, psi, ncas, maps, plan)
        e0 = c0 + (psi.conj() @ Hpsi).real
        w = 2.0 * Hpsi
        grad_c = (J.conj() @ w).real
        # mixed: from here on the Hessian-only work runs on f32 copies
        # (the JAX package's lp(J), lowered tables and f32 theta)
        J = lp(J)
        chunk = max(1, min(nt, _CHUNK_ELEMENTS // max(1, n2 * D)))
        chunks = [J[lo:lo + chunk] for lo in range(0, nt, chunk)]
        with parts(f"H J ({nt} rows)"):
            HJ = torch.cat([_ham.ham_apply(c1eff, c2, Jc, ncas, maps,
                                           plan_lp) for Jc in chunks])
        with parts("circuit-Hessian sweep"):
            term2 = pqc._state_hessian_dot_grid(lp(theta), lp(w), lp(psi),
                                                J)
        hess_cc = 2.0 * gram_last(J.conj(), HJ).real + term2
        del HJ

        with parts("RDMs of psi"):
            if streamed:
                # no (n^2, D) Phi: every RDM streams its own over grid rows
                phi = None
                gamma, Gamma = _rdms.rdms_from_state(
                    psi, ncas, maps, grid_order=True, plan=plan)
            else:
                phi = _rdms.apply_epq_all(psi, ncas, maps)     # (n^2, D)
                gamma, Gamma = _rdms.rdms_from_gram(phi, psi, ncas)
        phi_p = None if phi is None else lp(phi)
        psi_p = lp(psi)
        with parts("transition RDMs and Fock blocks"):
            grad, hess = assemble(h1, g2, gamma, Gamma, grad_c, hess_cc,
                                  (transition_rdms(phi_p, psi_p, Jc)
                                   for Jc in chunks))
        return e0, grad, hess

    def energy_gradient_staged(theta, oao, int1e_ao, int2e_ao, oao_coeff,
                               nuc):
        """(e0, [grad_c, grad_o], (gamma, Gamma)) with no Hessian work: the
        JAX package's gradient-only pipeline
        (auto_oo_tpu/models/oo_pqc.py:945-988), branch by branch on this
        core's route.  Hosted: ``hosted_pass``.  Else H psi through the
        route's H-apply (``ham_apply``; ``grid.ham_apply_rows`` streamed),
        the f64 reverse sweep, then the route's RDMs (f64 accumulators);
        in mixed precision the H-apply and the RDMs take the f32 state
        (the coefficients cast to f32 inside the H-apply) on the f32
        plan.  grad_o is the Fock pack at those RDMs (empty when n_kappa
        = 0).  Memory is O(D): psi, H psi and the reverse sweep's states;
        no (nt, D) or (n^2, D) stack beyond the route's own Phi."""
        h1, g2, c0, c1eff, c2 = coefficients(oao, int1e_ao, int2e_ao,
                                             oao_coeff, nuc)
        if hosted:
            gamma, Gamma, e0, grad_c = hosted_pass(theta, c0, c1eff,
                                                   c2)[3:]
        else:
            with parts("state sweep"):
                psi = pqc._state_impl_grid(theta)
                psi_p = lp(psi)
            with parts("H psi"):
                Hpsi = _ham.ham_apply(c1eff, c2, psi_p, ncas, maps, plan_lp)
            with parts("gradient sweep"):
                e0, grad_c = energy_grad(theta, psi, Hpsi, c0)
            del Hpsi
            with parts("RDMs"):
                gamma, Gamma = _rdms.rdms_from_state(
                    psi_p, ncas, maps, grid_order=True, plan=plan_lp)
        grad_o = (pack_grad(h1, g2, gamma, Gamma) if n_kappa
                  else grad_c.new_zeros(0))
        return e0, torch.cat([grad_c, grad_o]), (gamma, Gamma)

    def newton_update_on(energy_fn):
        """``newton_update`` with the Armijo trials' energies by
        ``energy_fn`` (``energy``'s signature)."""

        def newton_update(theta, oao, int1e_ao, int2e_ao, oao_coeff, nuc,
                          e0, grad, hess, alpha, beta, mu, rho, lambda_min):
            """Augmented-Newton solve + Armijo line search + MO update,
            given precomputed (e0, grad, hess)."""

            def objective(flat):
                return energy_fn(flat[:nt], flat[nt:], oao, int1e_ao,
                                 int2e_ao, oao_coeff, nuc)

            flat0 = torch.cat([theta, torch.zeros(
                n_kappa, dtype=theta.dtype, device=theta.device)])
            new_flat, lowest, t, e_t = damped_newton_step_pure(
                objective, flat0, grad, hess, alpha=alpha, beta=beta, mu=mu,
                rho=rho, lambda_min=lambda_min, e0=e0,
                min_rel_slack=(_HOSTED_MIXED_SLACK if mixed and hosted
                               else 0.0),
                method=newton_method)
            new_theta = new_flat[:nt]
            new_kappa = new_flat[nt:]
            # e_t IS the energy at (new_theta, new_oao): folding kappa
            # into the OAO coefficients leaves the MO matrix unchanged
            new_oao = oao @ expm(-k2m(new_kappa))
            return new_theta, new_kappa, new_oao, e_t, lowest

        return newton_update

    newton_update = newton_update_on(energy)
    nr_iteration = _nr_iteration_of(grad_hess, newton_update)

    # -- the batched core: a leading lane axis (the geometries of a
    # GeometryBatch, the trials of a line search, the one run of a device
    # loop), on the routes of the JAX GeometryBatch program.  Every lane
    # has its own integrals, OAO coefficients and parameters.  One sweep
    # carries every lane, and the Phi builds and E_pq reductions of several
    # lanes fold into one launch of the grid kernels (within the tangent
    # chunks' budget); every contraction over the state axis and the
    # orbital algebra run per lane on one lane's shapes, so that a lane's
    # Newton step is the one-lane (sequential) one: the card's GEMMs sum
    # in an order that depends on their shapes

    def batch_route():
        if route not in _BATCH_ROUTES:
            raise ValueError(
                f"the {route} route has no geometry batch: one (n^2, D) "
                f"Phi already exceeds its block per geometry (D = {D}); "
                f"the batched core runs on the {', '.join(_BATCH_ROUTES)} "
                "routes")

    def rotations(kappas):
        """expm(-kappa) of a stack (L, n_kappa): (L, nao, nao)."""
        return expm(-k2m(kappas))

    def folds(n_rows):
        """[lo, hi) row ranges of the folded kernel launches over n_rows
        states: as many as one (rows, n^2, D) Phi within the tangent
        chunks' budget holds (one at least)."""
        per = max(1, _CHUNK_ELEMENTS // max(1, n2 * D))
        return [(lo, min(n_rows, lo + per)) for lo in range(0, n_rows, per)]

    def energy_rot(thetas, R, oaos, int1e_ao, int2e_ao, oao_coeff, nuc):
        """E of L lanes (the JAX GeometryBatch's energy_one, vmapped) with
        their orbital rotations R (L, nao, nao) = expm(-kappa) given; the
        RDMs of the f64 state, as ``energy`` takes them on these
        routes."""
        batch_route()
        mo = oao_coeff @ oaos @ R
        mo_sub = mo.index_select(-1, sub)
        h1 = _tr.int1e_transform(int1e_ao, mo_sub)
        g2 = _tr.int2e_transform(int2e_ao, mo_sub)
        c0, c1, c2 = _tr.molecular_hamiltonian_coefficients(
            nuc, h1, g2, occ_rel, act_rel)
        psi = pqc._state_impl_grid(thetas)
        rdms = []
        for lo, hi in folds(psi.shape[0]):
            phi = _rdms.apply_epq_all(psi[lo:hi], ncas, maps)
            rdms += [_rdms.rdms_from_gram(phi[i], psi[lo + i], ncas)
                     for i in range(hi - lo)]
        return _tr.energy_from_rdms(c0, c1, c2,
                                    torch.stack([r[0] for r in rdms]),
                                    torch.stack([r[1] for r in rdms]))

    def energy_batch(thetas, kappas, oaos, int1e_ao, int2e_ao, oao_coeff,
                     nuc):
        """E(theta_i, kappa_i) of every lane: (L,)."""
        return energy_rot(thetas, rotations(kappas), oaos, int1e_ao,
                          int2e_ao, oao_coeff, nuc)

    def ham_y(c1eff, c2, x, phi):
        """``ham_apply``'s Y = C2 Phi + c1eff x of a (rows, D) x whose
        (rows, n^2, D) Phi is given (a slice of a folded build): the
        matmul of ``ham_apply`` on the same shapes, the c1eff term added
        in place, so that Y is the one (rows, n^2, D) buffer it
        allocates."""
        Y = torch.matmul(c2.reshape(n2, n2).to(x.dtype), phi)
        return Y.addcmul_(c1eff.reshape(n2).to(x.dtype)[None, :, None],
                          x[:, None])

    def stack_rows(Ys):
        return Ys[0] if len(Ys) == 1 else torch.cat(Ys)

    def grad_hess_batch(thetas, oaos, int1e_ao, int2e_ao, oao_coeff, nuc):
        """``grad_hess`` of B lanes at once, f64: (e0 (B,), grad (B, n),
        hess (B, n, n)); ``nuc`` is any length-B sequence.  One forward
        sweep gives every lane's (psi, J) and one reverse sweep every
        circuit-Hessian term; psi's Phi and the H-applies of psi and of
        the tangent chunks (per lane, of at most ``_CHUNK_ELEMENTS`` Phi
        elements) fold several lanes into one kernel launch, psi's Phi
        serves its H-apply and its RDMs, and each tangent chunk's Phi its
        H-apply and its transition RDMs."""
        batch_route()
        if mixed:
            raise ValueError("the batched core runs in f64 (the JAX "
                             "GeometryBatch program's precision)")
        B = thetas.shape[0]
        coefs = [coefficients(oaos[b], int1e_ao[b], int2e_ao[b],
                              oao_coeff[b], nuc[b]) for b in range(B)]
        with parts("state + J sweep"):
            # (B, D), (B, nt, D)
            psi, J = pqc._state_and_jacobian_grid(thetas)
        chunk = max(1, min(nt, _CHUNK_ELEMENTS // max(1, n2 * D)))
        # (lane, first, last tangent) of the tangent chunks, lane by lane;
        # consecutive chunks are consecutive rows of the flat (B nt, D) J
        units = [(b, t0, min(nt, t0 + chunk)) for b in range(B)
                 for t0 in range(0, nt, chunk)]
        per = max(1, _CHUNK_ELEMENTS // max(1, chunk * n2 * D))
        Jf = J.reshape(B * nt, D)
        Hpsi = torch.empty_like(psi)
        HJf = torch.empty_like(Jf)
        rdms, trdms = [None] * B, [[] for _ in range(B)]
        with parts("Phi folds (H psi, H J, RDMs, transition RDMs)"):
            for lo, hi in folds(B):
                phi = _rdms.apply_epq_all(psi[lo:hi], ncas, maps)
                Y = stack_rows([ham_y(coefs[b][3], coefs[b][4],
                                      psi[b][None], phi[b - lo:b - lo + 1])
                                for b in range(lo, hi)])
                Hpsi[lo:hi] = _grid_or_flat_sum(Y)
                del Y
                for b in range(lo, hi):
                    rdms[b] = _rdms.rdms_from_gram(phi[b - lo], psi[b], ncas)
                # these lanes' tangent chunks, whole chunks per folded
                # launch; each chunk's Phi serves its transition RDMs and
                # its H-apply, and goes (with its Y) before the next build:
                # psi's Phi, one chunk's Phi and its Y at most
                mine = [u for u in units if lo <= u[0] < hi]
                for u0 in range(0, len(mine), per):
                    group = mine[u0:u0 + per]
                    r0 = group[0][0] * nt + group[0][1]
                    r1 = group[-1][0] * nt + group[-1][2]
                    phiJ = _rdms.apply_epq_all(Jf[r0:r1], ncas, maps)
                    Ys = []
                    for b, t0, t1 in group:
                        Jc = J[b, t0:t1]
                        pj = phiJ[b * nt + t0 - r0:b * nt + t1 - r0]
                        if n_kappa:
                            trdms[b].append(transition_rdms(
                                phi[b - lo], psi[b], Jc, phiJ=pj))
                        Ys.append(ham_y(coefs[b][3], coefs[b][4], Jc, pj))
                    del phiJ, pj
                    Y = stack_rows(Ys)
                    del Ys
                    HJf[r0:r1] = _grid_or_flat_sum(Y)
                    del Y
                del phi
        HJ = HJf.reshape(B, nt, D)
        w = 2.0 * Hpsi
        with parts("circuit-Hessian sweep"):
            term2 = pqc._state_hessian_dot_grid(thetas, w, psi, J)
        e0s, grads, hesses = [], [], []
        with parts("Fock blocks"):
            for b in range(B):
                h1, g2, c0 = coefs[b][:3]
                e0s.append(c0 + (psi[b].conj() @ Hpsi[b]).real)
                grad_c = (J[b].conj() @ w[b]).real
                hess_cc = (2.0 * gram_last(J[b].conj(), HJ[b]).real
                           + term2[b])
                grad, hess = assemble(h1, g2, *rdms[b], grad_c, hess_cc,
                                      trdms[b])
                grads.append(grad)
                hesses.append(hess)
        return torch.stack(e0s), torch.stack(grads), torch.stack(hesses)

    def solve_batch(grad, hess, mu, rho, lambda_min):
        """The Newton solve of every lane without a host read of the
        port's own (a library solver's checks aside): eigh on the stack,
        or the iterative solve lane by lane in its sync-free form."""
        if newton_method == "iterative":
            out = [newton_step_pure(g_, h_, mu=mu, rho=rho,
                                    lambda_min=lambda_min,
                                    method="iterative", sync_free=True)
                   for g_, h_ in zip(grad, hess)]
            return (torch.stack([o[0] for o in out]),
                    torch.stack([o[1] for o in out]))
        return newton_step_pure(grad, hess, mu=mu, rho=rho,
                                lambda_min=lambda_min, method="eigh")

    def newton_update_batch(thetas, oaos, int1e_ao, int2e_ao, oao_coeff,
                            nuc, e0, grad, hess, alpha, beta, mu, rho,
                            lambda_min, rounds=None):
        """``newton_update`` of B lanes: the solve, the Armijo search of
        ``utils.newton_raphson.backtracking_batched`` (each round one
        ``energy_rot`` call over the lanes' trials; ``rounds`` None is one
        round of lmax trials and no host read), and the fold of each
        lane's kappa into its OAO coefficients by the rotation its
        accepted trial's energy used (the identity where the search was
        exhausted).  Returns (thetas, kappas, oaos, energies, lowest)."""
        batch_route()
        dp, lowest = solve_batch(grad, hess, mu, rho, lambda_min)
        flat0 = torch.cat([thetas, thetas.new_zeros((thetas.shape[0],
                                                     n_kappa))], dim=-1)

        def trial_energy(lanes, trials):
            R = rotations(trials[:, nt:])
            return energy_rot(trials[:, :nt], R, oaos[lanes],
                              int1e_ao[lanes], int2e_ao[lanes],
                              oao_coeff[lanes], nuc[lanes]), R

        new_flat, _t, e_t, ok, R = backtracking_batched(
            trial_energy, flat0, dp, grad, e0, alpha=alpha, beta=beta,
            lmax=_LMAX, rounds=rounds)
        eye = torch.eye(nao, dtype=oaos.dtype, device=oaos.device)
        new_oao = oaos @ torch.where(ok[:, None, None], R, eye)
        return new_flat[:, :nt], new_flat[:, nt:], new_oao, e_t, lowest

    def nr_iteration_batch(thetas, oaos, int1e_ao, int2e_ao, oao_coeff, nuc,
                           alpha, beta, mu, rho, lambda_min, rounds=None):
        """One damped-Newton iteration of every lane: ``grad_hess_batch``,
        then ``newton_update_batch``."""
        e0, grad, hess = grad_hess_batch(thetas, oaos, int1e_ao, int2e_ao,
                                         oao_coeff, nuc)
        return newton_update_batch(thetas, oaos, int1e_ao, int2e_ao,
                                   oao_coeff, nuc, e0, grad, hess, alpha,
                                   beta, mu, rho, lambda_min, rounds)

    if mesh is not None:
        return _mesh_core(pqc, maps, mesh, tangent_axis, state_axis,
                          coefficients, sub_coefficients, assemble,
                          trdm_blocks, parts, n_kappa, energy,
                          newton_update_on, route)

    return {"energy": energy, "grad_hess": grad_hess,
            "energy_gradient_staged": energy_gradient_staged,
            "newton_update": newton_update, "nr_iteration": nr_iteration,
            "newton_update_on": newton_update_on,
            "energy_batch": energy_batch, "grad_hess_batch": grad_hess_batch,
            "newton_update_batch": newton_update_batch,
            "nr_iteration_batch": nr_iteration_batch,
            "route": route, "hosted_form": form, "precision": precision,
            "plan": plan, "plan_lp": plan_lp, "cross_rows": cross_rows,
            "parts": parts}


def _nr_iteration_of(grad_hess, newton_update):
    """One damped-Newton iteration: ``grad_hess``, then ``newton_update``
    (the core's ``nr_iteration`` on the given pair)."""

    def nr_iteration(theta, oao, int1e_ao, int2e_ao, oao_coeff, nuc,
                     alpha, beta, mu, rho, lambda_min):
        e0, grad, hess = grad_hess(theta, oao, int1e_ao, int2e_ao,
                                   oao_coeff, nuc)
        return newton_update(theta, oao, int1e_ao, int2e_ao, oao_coeff, nuc,
                             e0, grad, hess, alpha, beta, mu, rho,
                             lambda_min)

    return nr_iteration


def _mesh_core(pqc, maps, mesh, tangent_axis, state_axis, coefficients,
               sub_coefficients, assemble, trdm_blocks, parts, n_kappa,
               energy, newton_update_on, route):
    """The mesh core (see ``_build_nr_core``): ``grad_hess``, ``energy``,
    ``newton_update`` and ``nr_iteration`` with the tangent rows split
    over ``tangent_axis`` and the state axis over ``state_axis``.

    ``grad_hess``, per call: the state and J by one whole sweep (every
    rank holds both whole, so Phi and the H-apply read them directly);
    psi's Phi block gives H psi (this rank's block, all-gathered: w = 2 H
    psi feeds the whole reverse sweep) and psi's RDMs (grams summed over
    the state axis); each chunk of this rank's tangent rows gives its H J
    block, its transition grams and its gradient pieces; the circuit gram
    <J_i, H J_j> of this rank's state block is summed over the state
    axis; the tangent blocks (gradient, gram columns, transition grams)
    are all-gathered over the tangent axis; the circuit-Hessian sweep and
    the Fock blocks run whole.

    ``energy``: with a state axis, c0 + <psi|H psi> with H psi by the
    state split (one reduce_scatter) and the dot summed over the axis;
    without one, the core's own energy, so a tangent-only step is the
    single-device step."""
    from ..parallel.distributed import Axis, all_gather
    from ..parallel.statevector import state_shard

    T = Axis(mesh, tangent_axis)
    S = state_shard(maps, pqc.ncas,
                    None if state_axis in (None, tangent_axis)
                    else Axis(mesh, state_axis))
    nt = int(pqc.theta_shape)
    n2 = pqc.ncas * pqc.ncas
    tb, (t0, t1) = T.block(nt)

    def tangent_gather(x):
        return all_gather(x.contiguous(), T)[:nt]

    def grad_hess(theta, oao, int1e_ao, int2e_ao, oao_coeff, nuc):
        h1, g2, c0, c1eff, c2 = coefficients(oao, int1e_ao, int2e_ao,
                                             oao_coeff, nuc)
        with parts("state + J sweep"):
            psi, J = pqc._state_and_jacobian_grid(theta)
        full = S.whole(psi)
        psi_loc = S.local(psi)
        phi = S.phi(full)                               # (n2, n_loc)
        Hpsi = S.flat(S.gather(S.ham(c1eff, c2, full, phi)))
        e0 = c0 + (psi.conj() @ Hpsi).real
        w = 2.0 * Hpsi
        gamma = S.reduce(gram_last(phi, psi_loc.conj()).real)
        corr = S.reduce(gram_last(phi.conj(), phi).real)
        with parts("circuit-Hessian sweep"):
            term2 = pqc._state_hessian_dot_grid(theta, w, psi, J)
        # this rank's tangent rows, zero rows past n_theta
        Jb = J.new_zeros((tb,) + tuple(J.shape[1:]))
        Jb[:max(0, min(t1, nt) - t0)] = J[t0:t1]
        Jb_loc = S.local(Jb)
        HJ_loc = torch.empty_like(Jb_loc)
        dgamma = Jb_loc.new_zeros((tb, n2), dtype=torch.float64)
        dgram = Jb_loc.new_zeros((tb, n2, n2), dtype=torch.float64)
        chunk = max(1, min(tb, _CHUNK_ELEMENTS
                           // max(1, n2 * Jb_loc.shape[-1])))
        with parts("H J and transition grams"):
            for lo in range(0, tb, chunk):
                hi = min(tb, lo + chunk)
                Jc = S.whole(Jb[lo:hi])
                phiJ = S.phi(Jc)                        # (c, n2, n_loc)
                HJ_loc[lo:hi] = S.ham(c1eff, c2, Jc, phiJ)
                if n_kappa:
                    A = gram_last(phiJ.conj(), phi).real
                    dgram[lo:hi] = A + A.transpose(1, 2)
                    dgamma[lo:hi] = (
                        gram_last(phiJ, psi_loc.conj()).real
                        + gram_last(phi, Jb_loc[lo:hi].conj()).real.T)
                del Jc, phiJ
        gc = S.reduce((Jb_loc.conj() @ S.local(w)).real)
        # <J_i, H J_j> for every i and this rank's columns j
        G_cols = S.reduce(gram_last(S.local(J).conj(), HJ_loc).real)
        grad_c = tangent_gather(gc)
        hess_cc = 2.0 * tangent_gather(G_cols.T).T + term2
        gamma, Gamma = _grid.assemble_rdms(gamma, corr, pqc.ncas)
        trdms = ([trdm_blocks(tangent_gather(S.reduce(dgamma)),
                              tangent_gather(S.reduce(dgram)))]
                 if n_kappa else [])
        grad, hess = assemble(h1, g2, gamma, Gamma, grad_c, hess_cc, trdms)
        return e0, grad, hess

    if S.axis is not None:
        def energy(theta, kappa, oao, int1e_ao, int2e_ao, oao_coeff, nuc):
            c0, c1, c2 = sub_coefficients(kappa, oao, int1e_ao, int2e_ao,
                                          oao_coeff, nuc)
            psi = pqc._state_impl_grid(theta)
            h_loc = S.ham(_ham.c1_effective(c1, c2), c2, S.whole(psi))
            dot = (S.local(psi).conj() @ h_loc).real
            return c0 + S.reduce(dot.reshape(1))[0]

    newton_update = newton_update_on(energy)
    return {"energy": energy, "grad_hess": grad_hess,
            "newton_update": newton_update,
            "nr_iteration": _nr_iteration_of(grad_hess, newton_update),
            "route": route, "parts": parts}


class OO_pqc(OO_energy):
    """Orbital-optimized PQC energy (reference oo_pqc.py:30), on the
    circuit's device.

    ``precision`` is "f64" or "mixed" (the Hessian blocks in float32,
    see the module docstring).  ``stream_plan`` (a grid.StreamPlan)
    forces the streamed route with that row chunk and pair block below
    the hosting threshold (it holds the streamed route against the fused
    one at a small D), and sets the hosted route's row chunks at or above
    it; by default the route follows the JAX package's rule and, when
    streamed or hosted, its sizes come from the free device memory at
    construction.  ``hosted_form`` ("gram" or "per_tangent") forces the
    hosted route's form (a ValueError on any other route); by default
    it is the JAX package's choice (``_core["hosted_form"]``).
    ``newton_method`` is "eigh" or "iterative"
    (ops/linalg.newton_dir_iterative); None is "eigh" at every size,
    where the JAX package's None takes the iterative solve on a TPU from
    n = 128."""

    def __init__(self, pqc, mol, ncas, nelecas, oao_mo_coeff=None,
                 freeze_active=False, interface=None, newton_method=None,
                 precision="f64", stream_plan=None, hosted_form=None):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, "
                             f"got {precision!r}")
        if hosted_form not in (None,) + _HOSTED_FORMS:
            raise ValueError(f"hosted_form must be one of {_HOSTED_FORMS}"
                             f", got {hosted_form!r}")
        if newton_method not in (None, "eigh", "iterative"):
            raise ValueError("newton_method must be None, 'eigh' or "
                             f"'iterative', got {newton_method!r}")
        super().__init__(mol, ncas, nelecas, oao_mo_coeff=oao_mo_coeff,
                         freeze_active=freeze_active, device=pqc.device)
        self.pqc = pqc
        self.newton_method = newton_method
        self.precision = precision
        self._core = _build_nr_core(pqc, self.nao, self._occ, self._act,
                                    self.params_idx, stream_plan, precision,
                                    hosted_form, newton_method)
        self._mol_args = (self.int1e_ao, self.int2e_ao, self.oao_coeff,
                          self.nuc)

    def _theta(self, theta):
        return torch.as_tensor(theta, dtype=self.oao_mo_coeff.dtype,
                               device=self.device).reshape(-1)

    def energy_from_parameters(self, theta, kappa=None):
        """Hybrid cost E(theta, kappa) (reference oo_pqc.py:64-84)."""
        theta = self._theta(theta)
        if kappa is None:
            kappa = torch.zeros(self.n_kappa, dtype=theta.dtype,
                                device=self.device)
        kappa = torch.as_tensor(kappa, dtype=theta.dtype, device=self.device)
        return self._core["energy"](theta, kappa, self.oao_mo_coeff,
                                    *self._mol_args)

    def _grad_hess(self, theta):
        return self._core["grad_hess"](self._theta(theta),
                                       self.oao_mo_coeff, *self._mol_args)

    def _lane_args(self):
        """The molecule arrays with a leading lane axis of 1 (the batched
        core's arguments for this one geometry)."""
        int1e, int2e, oao_coeff, nuc = self._mol_args
        return (int1e[None], int2e[None], oao_coeff[None],
                torch.tensor([nuc], dtype=int1e.dtype, device=self.device))

    def _nr_iteration(self, theta, oao, alpha, beta, mu, rho, lambda_min):
        return self._core["nr_iteration"](theta, oao, *self._mol_args,
                                          alpha, beta, mu, rho, lambda_min)

    @property
    def _nt(self):
        return int(self.pqc.theta_shape)

    # -- reference-API derivative blocks (views of one grad_hess) ---------

    def circuit_gradient(self, theta):
        """dE/dtheta (reference oo_pqc.py:86-95)."""
        return self._grad_hess(theta)[1][:self._nt]

    def orbital_gradient(self, theta):
        """Analytic Fock gradient at the RDMs of theta
        (reference oo_pqc.py:97-101)."""
        return self._grad_hess(theta)[1][self._nt:]

    def circuit_circuit_hessian(self, theta):
        """d2E/dtheta2 (reference oo_pqc.py:103-111)."""
        return self._grad_hess(theta)[2][:self._nt, :self._nt]

    def orbital_circuit_hessian(self, theta):
        """Mixed block, shape (n_kappa, n_theta)
        (reference oo_pqc.py:113-125)."""
        return self._grad_hess(theta)[2][self._nt:, :self._nt]

    def orbital_orbital_hessian(self, theta):
        """Analytic orbital Hessian at the RDMs of theta
        (reference oo_pqc.py:127-130)."""
        return self._grad_hess(theta)[2][self._nt:, self._nt:]

    def full_gradient(self, theta):
        """[circuit, orbital] gradient (reference oo_pqc.py:132-134)."""
        return self._grad_hess(theta)[1]

    def full_hessian(self, theta):
        """2x2 block Hessian (reference oo_pqc.py:136-148)."""
        return self._grad_hess(theta)[2]

    def full_circuit_hessian_to_matrix(self, full_circuit_hessian):
        """The circuit Hessian as an (n_theta, n_theta) matrix (the JAX
        package's auto_oo_tpu/models/oo_pqc.py:1356-1358)."""
        size = int(np.prod(self.pqc.theta_shape))
        return full_circuit_hessian.reshape(size, size)

    # -- the optimizer loops ---------------------------------------------

    def energy_and_gradient(self, theta):
        """(E, full [circuit, orbital] gradient, (gamma, Gamma)) with no
        Hessian work: the state, one H-apply (with the RDMs in one pass on
        the hosted route), one adjoint reverse sweep and the RDMs (see
        ``energy_gradient_staged`` in ``_build_nr_core``).  The derivative
        path that fits a card from (14e,14o) up: no (n_theta, D) stack."""
        return self._core["energy_gradient_staged"](
            self._theta(theta), self.oao_mo_coeff, *self._mol_args)

    def gradient_optimization(self, theta_init, max_iterations=200,
                              learning_rate=0.05, conv_tol=None,
                              orbital_every=10, orbital_kwargs=None,
                              verbose=0, flush=True, monitor=None,
                              optimizer=None, eval_fn=None):
        """Two-step first-order OO-VQE (reference-API extension of the JAX
        package, auto_oo_tpu/models/oo_pqc.py:1372-1444): Adam on the
        circuit parameters with the analytic gradient, and a damped-Newton
        orbital relaxation (``orbital_optimization``) at the current RDMs
        every ``orbital_every`` steps where n_kappa > 0.  Returns
        (energy_l, theta).  The optimizer of the problems whose
        quadratic-form Hessian cannot fit; at small D prefer
        ``full_optimization``.

        ``optimizer`` is any object with ``init(theta)`` and
        ``update(grad, state, theta)`` (utils/optim.py; default
        ``adam(learning_rate)``, optax's Adam).  ``eval_fn`` overrides the
        evaluation: theta -> (energy, circuit_gradient, rdms_thunk), the
        thunk returning (gamma, Gamma) at the same theta, called only on
        relaxation steps.  The RDMs are those of the pre-update theta;
        the relaxation runs after the update and changes
        ``self.oao_mo_coeff``, which the next evaluation reads.
        ``conv_tol`` defaults to 1e-8 (f64) and 1e-5 (mixed, whose
        energies carry ~1e-6 relative noise): the loop stops after two
        consecutive energy changes below it.  ``monitor.log(n, energy)``
        is called for every step."""
        if conv_tol is None:
            conv_tol = 1e-5 if self.precision == "mixed" else 1e-8
        theta = self._theta(theta_init)
        opt = _optim.adam(learning_rate) if optimizer is None else optimizer
        opt_state = opt.init(theta)
        orbital_kwargs = dict(orbital_kwargs or {})
        orbital_kwargs.setdefault("max_iterations", 20)
        orbital_kwargs.setdefault("verbose", 0)
        nt = self._nt
        if eval_fn is None:
            def eval_fn(th):
                e, grad, rdms = self.energy_and_gradient(th)
                return e, grad[:nt], (lambda: rdms)
        energy_l = []
        for n in range(max_iterations):
            e, grad_c, rdms_thunk = eval_fn(theta)
            energy_l.append(float(e))
            if monitor is not None:
                monitor.log(n, energy_l[-1])
            if verbose:
                print(f"iter = {n:03}, energy = {energy_l[-1]:.12f}",
                      flush=flush)
            relax = (orbital_every and (n + 1) % orbital_every == 0
                     and self.n_kappa)
            if relax:
                # the RDMs at the pre-update theta (the gradient's point)
                g1, G2 = rdms_thunk()
            updates, opt_state = opt.update(grad_c, opt_state, theta)
            theta = _optim.apply_updates(theta, updates)
            if relax:
                orb_l = self.orbital_optimization(g1, G2, **orbital_kwargs)
                if orb_l and verbose:
                    print(f"  orbital relaxation -> {orb_l[-1]:.12f}",
                          flush=flush)
            if (n > 2 and abs(energy_l[-1] - energy_l[-2]) < conv_tol
                    and abs(energy_l[-2] - energy_l[-3]) < conv_tol):
                break
        return energy_l, theta

    def full_optimization(self, theta_init, max_iterations=50,
                          conv_tol=1e-10, verbose=0, flush=True,
                          alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1,
                          lambda_min=1e-6, monitor=None, device_loop=False,
                          **kwargs):
        """Newton-Raphson on (theta, kappa) jointly
        (reference oo_pqc.py:155-207).

        Returns (energy_l, theta_l, kappa_l, oao_mo_coeff_l, hess_eig_l)
        and leaves the final OAO coefficients in ``self.oao_mo_coeff``.
        ``monitor.log(iteration, energy, lowest_hess_eig=...)`` is called
        after every iteration.

        ``device_loop=True`` is the JAX package's one-program run
        (auto_oo_tpu/models/oo_pqc.py:1124-1174, 1497-1530): the same
        iterations, with no host read in an iteration's body (see
        ``_full_optimization_device``); ``monitor`` and ``verbose`` output
        comes after the run.  At D >= 2^19 (the JAX package's staged
        pipeline, host-driven by design) it raises ValueError."""
        theta = self._theta(theta_init)
        if device_loop:
            return self._full_optimization_device(
                theta, max_iterations, conv_tol, verbose, flush, alpha, beta,
                mu, rho, lambda_min, monitor)
        if verbose:
            energy_init = float(self.energy_from_parameters(theta))
            print(f"iter = 000, energy = {energy_init:.12f}", flush=flush)

        theta_l, kappa_l, oao_mo_coeff_l = [], [], []
        energy_l, hess_eig_l = [], []
        for n in range(max_iterations):
            theta, kappa, new_oao, energy, lowest = self._nr_iteration(
                theta, self.oao_mo_coeff, alpha, beta, mu, rho, lambda_min)
            self.oao_mo_coeff = new_oao
            theta_l.append(theta)
            kappa_l.append(kappa)
            oao_mo_coeff_l.append(new_oao)
            energy_l.append(float(energy))
            hess_eig_l.append(float(lowest))
            if monitor is not None:
                monitor.log(n + 1, energy_l[-1],
                            lowest_hess_eig=hess_eig_l[-1])
            if verbose:
                print(f"iter = {n + 1:03}, energy = {energy_l[-1]:.12f}",
                      flush=flush)
            if n > 1 and abs(energy_l[-1] - energy_l[-2]) < conv_tol:
                if verbose:
                    print("optimization finished.")
                    print("E_fin =", energy_l[-1])
                break
        return energy_l, theta_l, kappa_l, oao_mo_coeff_l, hess_eig_l

    def _full_optimization_device(self, theta, max_iterations, conv_tol,
                                  verbose, flush, alpha, beta, mu, rho,
                                  lambda_min, monitor):
        """The device loop of ``full_optimization``.  Each iteration runs
        ``grad_hess``, the solve (eigh, or the iterative solve in its
        sync-free form) and one Armijo round of all lmax trials in one
        batched energy call with the first accepted trial picked on the
        device (``newton_update_batch`` on one lane), and writes its
        energy, lowest eigenvalue, theta, kappa and OAO matrix into
        preallocated device buffers.  The convergence test of the host
        loop (iteration n, 0-based, is the last if n > 1 and |e_n -
        e_{n-1}| < conv_tol) runs on the device: a flag the host reads
        once every ``_CHECK_EVERY`` iterations; iterations after the
        flag is set repeat the converged one and are thrown away.  The
        trajectory is fetched once, after the loop.  The only host waits
        inside an iteration are those of library calls (the info checks
        of ``torch.linalg.eigh`` / ``eigvalsh``, ``matrix_exp``'s read of
        its squaring counts; PERF.md counts them)."""
        core = self._core
        D = self.pqc.state_dim
        if D >= _STAGED_MIN_D:
            raise ValueError(
                f"device_loop=True is unavailable for the staged large-D "
                f"pipeline (D = {D} >= 2^19, host-driven by design in the "
                f"JAX package); use the default host loop")
        if core["route"] not in _BATCH_ROUTES:
            raise ValueError(
                f"device_loop=True runs on the {', '.join(_BATCH_ROUTES)} "
                f"routes, not the {core['route']} one")
        n_max = int(max_iterations)
        oao = self.oao_mo_coeff
        nt, nk = self._nt, self.n_kappa
        kw = dict(dtype=oao.dtype, device=oao.device)
        e_buf = torch.zeros(n_max, **kw)
        l_buf = torch.zeros(n_max, **kw)
        t_buf = torch.zeros((n_max, nt), **kw)
        k_buf = torch.zeros((n_max, nk), **kw)
        o_buf = torch.zeros((n_max,) + tuple(oao.shape), **kw)
        done = torch.zeros((), dtype=torch.bool, device=oao.device)
        n_done = torch.zeros((), dtype=torch.int64, device=oao.device)
        lanes = self._lane_args()
        e_prev = None
        for n in range(n_max):
            e0, grad, hess = core["grad_hess"](theta, oao, *self._mol_args)
            th2, kap, oa2, e_t, low = (x[0] for x in core[
                "newton_update_batch"](theta[None], oao[None], *lanes,
                                       e0[None], grad[None], hess[None],
                                       alpha, beta, mu, rho, lambda_min))
            live = ~done
            e_buf[n], l_buf[n], t_buf[n], k_buf[n], o_buf[n] = (
                e_t, low, th2, kap, oa2)
            theta = torch.where(live, th2, theta)
            oao = torch.where(live, oa2, oao)
            n_done = n_done + live.long()
            if n > 1:
                done = done | (live & ((e_t - e_prev).abs() < conv_tol))
            e_prev = e_t if e_prev is None else torch.where(live, e_t,
                                                            e_prev)
            if (n + 1) % _CHECK_EVERY == 0 and n + 1 < n_max and bool(done):
                break
        # the one fetch of the run's scalars
        head = torch.cat([torch.stack([n_done.to(e_buf.dtype),
                                       done.to(e_buf.dtype)]), e_buf,
                          l_buf]).tolist()
        n, converged = int(head[0]), bool(head[1])
        energy_l = head[2:2 + n]
        hess_eig_l = head[2 + n_max:2 + n_max + n]
        theta_l = [t_buf[i] for i in range(n)]
        kappa_l = [k_buf[i] for i in range(n)]
        oao_mo_coeff_l = [o_buf[i] for i in range(n)]
        if n:
            self.oao_mo_coeff = oao_mo_coeff_l[-1]
        for i in range(n):
            if monitor is not None:
                monitor.log(i + 1, energy_l[i], lowest_hess_eig=hess_eig_l[i])
            if verbose:
                print(f"iter = {i + 1:03}, energy = {energy_l[i]:.12f}",
                      flush=flush)
        if verbose and converged:
            print("optimization finished.")
            print("E_fin =", energy_l[-1])
        return energy_l, theta_l, kappa_l, oao_mo_coeff_l, hess_eig_l
