"""The plain reference of an OO-VQE cell: energy, gradient, Hessian and the
first steps of damped Newton and of Adam, from the geometry alone.

It imports nothing of the program under test and takes nothing it made:
its own integrals, RHF orbitals (sign-fixed), determinant grid, gate
fabric and optimizers.  Every orbital is active and frozen (no orbital
rotations), so the energy is E(theta) = <psi(theta)|H|psi(theta)> +
E_nuc.  ``dtype`` float32 gives the control: the same arithmetic one
precision lower.
"""

import numpy as np
import torch

from . import chem, fci
from .fabric import Fabric

#: the Armijo search of the damped Newton step: first trial t = 1, then
#: t times beta, at most LMAX trials, with a roundoff slack of 64 float64
#: ulps of max(1, |e0|) on the test
LMAX = 20
SLACK_ULPS = 64.0


class Reference:
    def __init__(self, geometry, n_orb, n_layers, device,
                 dtype=torch.float64):
        # float32 products on the card in float32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.e_nuc, h, g, self.e_rhf = chem.mo_hamiltonian(geometry, n_orb)
        self.space = fci.Space(n_orb, n_orb // 2, device, dtype)
        self.ham = fci.hamiltonian(self.space, h, g)
        self.fabric = Fabric(self.space, n_layers)
        self.dtype = dtype

    def energy(self, theta):
        """(E, psi, H psi) at theta."""
        psi = self.fabric.state(theta)
        hpsi = fci.apply_h(self.space, self.ham, psi)
        return float((psi * hpsi).sum()) + self.e_nuc, psi, hpsi

    def energy_gradient(self, theta):
        e, psi, hpsi = self.energy(theta)
        grad = self.fabric.gradient(theta, psi, 2.0 * hpsi)
        return e, grad

    def hessian(self, theta):
        """(E, gradient, Hessian): H_ij = 2 <J_i|H|J_j> + <2 H psi,
        d2 psi / d theta_i d theta_j>."""
        e, psi, hpsi = self.energy(theta)
        w = 2.0 * hpsi
        grad = self.fabric.gradient(theta, psi, w)
        del psi
        J, S = self.fabric.jacobian_and_curvature(theta, w)
        del w, hpsi
        nt = len(J)
        G = torch.zeros((nt, nt), dtype=torch.float64)
        for j in range(nt):
            hj = fci.apply_h(self.space, self.ham, J[j])
            G[:, j] = (J * hj).sum((1, 2)).double().cpu()
            del hj
        return e, grad, 2.0 * G + S

    def newton(self, theta0, steps, alpha, beta, mu, rho, lambda_min):
        """``steps`` damped-Newton iterations from theta0: the exact eigh
        solve dp = -(H + shift)^-1 g, shift = mu + rho |l0| where the
        lowest eigenvalue l0 < lambda_min, then the Armijo search.  Returns
        a list of (theta, energy, lowest eigenvalue, t) after each."""
        theta = torch.as_tensor(theta0, dtype=torch.float64).clone()
        out = []
        eps = float(np.finfo(np.float64).eps)
        for _ in range(steps):
            e0, grad, hess = self.hessian(theta)
            w, V = torch.linalg.eigh(hess.to(self.dtype))
            w, V, grad_l = w.double(), V.double(), grad.to(
                self.dtype).double()
            low = float(w[0])
            shift = mu + rho * abs(low) if low < lambda_min else 0.0
            dp = -(V @ ((V.T @ grad_l) / (w + shift)))
            gdp = float(grad_l @ dp)
            slack = SLACK_ULPS * eps * max(1.0, abs(e0))
            t, e_t = 1.0, None
            for _ in range(LMAX):
                e_try = self.energy(theta + t * dp)[0]
                if e_try <= e0 + alpha * t * gdp + slack:
                    e_t = e_try
                    break
                t *= beta
            if e_t is None:
                t, e_t = 0.0, e0
            theta = theta + t * dp
            out.append((theta.clone(), e_t, low, t))
        return out

    def adam(self, theta0, steps, learning_rate, b1=0.9, b2=0.999,
             eps=1e-8):
        """``steps`` Adam steps from theta0 in optax's order.  Returns
        (energies before each update, the first gradient, theta after the
        steps)."""
        theta = np.array(theta0, dtype=np.float64)
        m, v = np.zeros_like(theta), np.zeros_like(theta)
        energies, first = [], None
        for n in range(1, steps + 1):
            e, grad = self.energy_gradient(theta)
            g = grad.numpy()
            energies.append(e)
            if first is None:
                first = g.copy()
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * g ** 2 + b2 * v
            m_hat = m / (1 - b1 ** n)
            v_hat = v / (1 - b2 ** n)
            theta = theta + (-learning_rate) * (m_hat / (np.sqrt(v_hat) + eps))
        return energies, first, theta
