"""Stacked-geometry evaluation and optimization (the dp axis).

Port of ``GeometryBatch`` of auto_oo_tpu/parallel/sharding.py:197-377:
one functional, many molecules, the scaling axis of PES scans and
Berry-phase loops.  The JAX package vmaps its per-geometry programs over
the stacked integrals; here every geometry is a lane of the batched core
of ``OO_pqc`` (models/oo_pqc.py ``_build_nr_core``): one sweep carries
every lane's state and tangents, and the lanes fold into the leading
batch of the grid kernels as far as the Phi budget of one launch
(``_CHUNK_ELEMENTS``) allows.  Where one lane's tangent chunk fills that
budget ((10e,10o) on), only psi's Phi and the trial energies fold, so a
batched step of B geometries launches fewer kernels than B sequential
steps but many more than one (PERF.md section 6 counts them).  All lanes
run on the circuit's device.

Every geometry shares the circuit, the active space and the frozen
rotations (``occ``, ``act``, ``params_idx`` of the first geometry), as
in the JAX package.  The batch runs on the routes of the JAX
GeometryBatch program ("flat", "fused", "staged"); on the streamed and
hosted routes, where one Phi already exceeds its block per geometry, the
constructor raises ValueError.  A ``mesh`` (the JAX package's dp
sharding across devices) raises NotImplementedError: the multi-rank
engines are ROADMAP queue 1 item 8.
"""

import torch

from ..models.oo_pqc import _BATCH_ROUTES, _CHECK_EVERY, _LMAX, OO_pqc

# the trials of the two rounds of ``newton_steps``' line search: t = 1
# for every geometry, then the rest for the geometries still searching
_ROUNDS = (1, _LMAX - 1)


class GeometryBatch:
    """Stacked-geometry evaluation (dp axis): one functional, many
    molecules (the JAX package's BASELINE.json config 5)."""

    def __init__(self, mols, ncas, nelecas, pqc, mesh=None, axis="dp",
                 freeze_active=True):
        if mesh is not None:
            raise NotImplementedError(
                "GeometryBatch(mesh=...) shards the geometries across "
                "devices: that needs the torch.distributed engines, ROADMAP "
                "queue 1 item 8; mesh=None runs every geometry on the "
                "circuit's device")
        self.oo_list = [OO_pqc(pqc, m, ncas, nelecas,
                               freeze_active=freeze_active) for m in mols]
        self.pqc = pqc
        oo0 = self.oo_list[0]
        self.oo0 = oo0
        self.mesh = mesh
        self.axis = axis
        route = oo0._core["route"]
        if route not in _BATCH_ROUTES:
            raise ValueError(
                f"GeometryBatch runs on the {', '.join(_BATCH_ROUTES)} "
                f"routes; this circuit takes the {route} route (D = "
                f"{pqc.state_dim}), where one Phi already exceeds its "
                "block per geometry")
        # one core serves every geometry: its molecule arrays are
        # arguments
        self._core = oo0._core
        self.int1e = torch.stack([oo.int1e_ao for oo in self.oo_list])
        self.int2e = torch.stack([oo.int2e_ao for oo in self.oo_list])
        self.oao_c = torch.stack([oo.oao_coeff for oo in self.oo_list])
        self.nuc = torch.tensor([oo.nuc for oo in self.oo_list],
                                dtype=self.int1e.dtype, device=pqc.device)

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
        return self._core["energy_batch"](
            self._tensor(thetas), self._tensor(kappas),
            self._tensor(oao_mos), *self._args)

    def gradients(self, thetas, kappas, oao_mos):
        """Batched (dE/dtheta (B, nt), dE/dkappa (B, n_kappa)), by
        autograd through the batched energy (the grid kernels are
        autograd Functions)."""
        with torch.enable_grad():
            th = self._tensor(thetas).detach().requires_grad_(True)
            ka = self._tensor(kappas).detach().requires_grad_(True)
            e = self._core["energy_batch"](th, ka, self._tensor(oao_mos),
                                           *self._args)
            g_th, g_ka = torch.autograd.grad(e.sum(), (th, ka))
        return g_th, g_ka

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
        return self._core["nr_iteration_batch"](
            thetas, oao_mos, *self._args, alpha, beta, mu, rho, lambda_min,
            rounds=_ROUNDS)

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
            th2, _kap, oa2, e_t, low = self._core["nr_iteration_batch"](
                thetas, oaos, *self._args, alpha, beta, mu, rho,
                lambda_min)
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
