"""Noisy OO-PQC: damped Newton on derivative blocks with Gaussian noise.

Port of auto_oo_tpu/models/noisy_oo_pqc.py (reference noisy_oo_pqc.py:21-
152: additive Gaussian noise of a given variance on every gradient and
Hessian block, feeding the damped-Newton optimizer), with the reference's
fixes kept: the variance is plumbed through ``full_noisy_optimization``,
and the randomness comes from an explicit generator, so a run is
reproducible.  The JAX package's PRNG keys become one ``torch.Generator``
on the OO_pqc's device, seeded by ``seed``; where the JAX package takes
``key=`` the port takes ``generator=``.  The draws differ from the JAX
package's stream; at variance 0 the two agree to rounding.
"""

import torch

from .oo_pqc import OO_pqc


class Noisy_OO_pqc(OO_pqc):
    """OO_pqc with Gaussian noise on the derivative blocks
    (reference noisy_oo_pqc.py:21)."""

    def __init__(self, pqc, mol, ncas, nelecas, oao_mo_coeff=None,
                 freeze_active=False, seed=0):
        super().__init__(pqc, mol, ncas, nelecas, oao_mo_coeff=oao_mo_coeff,
                         freeze_active=freeze_active)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)

    def _gen(self, generator=None):
        return self.generator if generator is None else generator

    def _noisify(self, exact, variance, generator=None):
        """exact + sqrt(variance) N(0, 1), drawn from ``generator`` (by
        default the object's)."""
        noise = torch.randn(exact.shape, generator=self._gen(generator),
                            dtype=exact.dtype, device=exact.device)
        return exact + variance ** 0.5 * noise

    def noisy_circuit_gradient(self, theta, variance, generator=None):
        return self._noisify(self.circuit_gradient(theta), variance,
                             generator)

    def noisy_orbital_gradient(self, theta, variance, generator=None):
        return self._noisify(self.orbital_gradient(theta), variance,
                             generator)

    def noisy_circuit_circuit_hessian(self, theta, variance, generator=None):
        return self._noisify(self.circuit_circuit_hessian(theta), variance,
                             generator)

    def noisy_orbital_circuit_hessian(self, theta, variance, generator=None):
        return self._noisify(self.orbital_circuit_hessian(theta), variance,
                             generator)

    def noisy_orbital_orbital_hessian(self, theta, variance, generator=None):
        return self._noisify(self.orbital_orbital_hessian(theta), variance,
                             generator)

    def full_noisy_gradient(self, theta, variance, generator=None):
        return torch.cat([
            self.noisy_circuit_gradient(theta, variance, generator),
            self.noisy_orbital_gradient(theta, variance, generator)])

    def full_noisy_hessian(self, theta, variance, generator=None):
        hess_cc = self.noisy_circuit_circuit_hessian(theta, variance,
                                                     generator)
        hess_oc = self.noisy_orbital_circuit_hessian(theta, variance,
                                                     generator)
        hess_oo = self.noisy_orbital_orbital_hessian(theta, variance,
                                                     generator)
        return torch.cat([torch.cat([hess_cc, hess_oc.T], dim=1),
                          torch.cat([hess_oc, hess_oo], dim=1)])

    def _noisy_step(self, theta, oao, variance, alpha, beta, mu, rho,
                    lambda_min):
        """One noisy damped-Newton iteration: the shared exact grad_hess,
        block-wise Gaussian noise on the gradient and on the cc, oc and
        oo Hessian blocks (the reference's per-block model,
        noisy_oo_pqc.py:52-100; the cc block's noise is not symmetric,
        and the eigh solve takes its symmetric part, as the JAX package's
        does), then the core's Newton update, whose Armijo search uses
        the EXACT energy."""
        core = self._core
        e0, grad, hess = core["grad_hess"](theta, oao, *self._mol_args)
        nt, nk = self._nt, self.n_kappa
        grad = self._noisify(grad, variance)
        ncc = self._noisify(hess.new_zeros((nt, nt)), variance)
        noc = self._noisify(hess.new_zeros((nk, nt)), variance)
        noo = self._noisify(hess.new_zeros((nk, nk)), variance)
        hess = hess + torch.cat([torch.cat([ncc, noc.T], dim=1),
                                 torch.cat([noc, noo], dim=1)])
        return core["newton_update"](theta, oao, *self._mol_args, e0, grad,
                                     hess, alpha, beta, mu, rho, lambda_min)

    def full_noisy_optimization(self, theta_init, variance,
                                max_iterations=50, conv_tol=1e-10,
                                verbose=0, generator=None, alpha=1e-4,
                                beta=0.5, mu=1e-6, rho=1.1, lambda_min=1e-6,
                                **kwargs):
        """Damped-Newton optimization with noisy derivatives (reference
        noisy_oo_pqc.py:102-152).  ``generator`` replaces the object's
        generator for this and later draws.  Returns (energy_l, theta_l,
        kappa_l, oao_mo_coeff_l, hess_eig_l) and leaves the final OAO
        coefficients in ``self.oao_mo_coeff``."""
        theta = self._theta(theta_init)
        if generator is not None:
            self.generator = generator
        if verbose:
            energy_init = float(self.energy_from_parameters(theta))
            print(f"iter = 000, energy = {energy_init:.12f}")
        theta_l, kappa_l, oao_mo_coeff_l = [], [], []
        energy_l, hess_eig_l = [], []
        for n in range(max_iterations):
            theta, kappa, new_oao, energy, lowest = self._noisy_step(
                theta, self.oao_mo_coeff, float(variance), alpha, beta, mu,
                rho, lambda_min)
            self.oao_mo_coeff = new_oao
            theta_l.append(theta)
            kappa_l.append(kappa)
            oao_mo_coeff_l.append(new_oao)
            energy_l.append(float(energy))
            hess_eig_l.append(float(lowest))
            if verbose:
                print(f"iter = {n + 1:03}, energy = {energy_l[-1]:.12f}")
            if n > 1 and abs(energy_l[-1] - energy_l[-2]) < conv_tol:
                if verbose:
                    print("optimization finished.")
                    print("E_fin =", energy_l[-1])
                break
        return energy_l, theta_l, kappa_l, oao_mo_coeff_l, hess_eig_l
