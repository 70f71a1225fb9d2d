"""OO-VQE end to end: formaldimine (4e,3o) to CASSCF, then circuit-only
Adam against CASCI.

    python -m auto_oo_tpu_torch.scripts.tutorial_oo_vqe [--device cpu]
        [--adam-steps N]

Port of examples/tutorial_oo_vqe.py (the reference's Tutorial_auto_oo
notebook as a script):

1. formaldimine (140, 80) in sto-3g and a (4e,3o) active space;
2. a GateFabric PQC (np_fabric, 2 layers) and the hybrid OO-PQC cost,
   with the active-active rotations frozen;
3. damped-Newton optimization of (theta, kappa) from theta = 0;
4. the energy against CASSCF;
5. circuit-only optimization: 300 Adam steps at learning rate 5e-2 on
   <psi|H|psi>, H the CAS Hamiltonian at the RHF orbitals
   (``fermionic_cas_hamiltonian``), against CASCI of any spin (the
   GateFabric circuit keeps N and S_z but not S^2).  Adam is
   ``utils.optim.adam`` (optax's order of operations) and the gradient
   comes from ``torch.autograd`` through the circuit's state.

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import sys

import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.utils.optim import adam, apply_updates

NCAS, NELECAS = 3, 4


def build(device=None):
    """(mol, pqc, oo_pqc) of the tutorial's problem on ``device``."""
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(NCAS, NELECAS, ansatz="np_fabric",
                                  n_layers=2, device=device)
    oo = P.OO_pqc(pqc, mol, NCAS, NELECAS, freeze_active=True)
    return mol, pqc, oo


def newton_run(oo, pqc, conv_tol=1e-10, verbose=0, **kwargs):
    """``full_optimization`` from theta = 0: (energy_l, theta_l, kappa_l,
    oao_mo_coeff_l, hess_eig_l)."""
    return oo.full_optimization(pqc.init_zeros(), conv_tol=conv_tol,
                                verbose=verbose, **kwargs)


def cas_hamiltonian(mol, oo):
    """The dense CAS Hamiltonian over the 4^ncas space at the RHF
    orbitals, on the OO_pqc's device."""
    mol.run_rhf()
    c0, c1, c2 = oo.get_active_integrals(mol.hf.mo_coeff)
    H = P.fermionic_cas_hamiltonian(c0, c1, c2).toarray()
    return torch.as_tensor(H, dtype=torch.float64, device=oo.device)


def adam_run(pqc, H, steps=300, learning_rate=5e-2):
    """Circuit-only Adam on <psi(theta)|H|psi(theta)> from theta = 0:
    the energy at each step before its update (the JAX example prints
    the last of them) and the final theta."""
    opt = adam(learning_rate)
    theta = pqc.init_zeros()
    state = opt.init(theta)
    energies = []
    for _ in range(steps):
        th = theta.detach().requires_grad_(True)
        psi = pqc.state(th)
        e = psi @ (H @ psi)
        (g,) = torch.autograd.grad(e, th)
        energies.append(e.detach())
        updates, state = opt.update(g, state)
        theta = apply_updates(theta, updates)
    return torch.stack(energies).tolist(), theta


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--adam-steps", type=int, default=300)
    args = parser.parse_args(argv)

    # 1. molecule + active space; 2. PQC + OO-PQC cost
    mol, pqc, oo = build(args.device)
    print(f"formaldimine sto-3g: nao={mol.nao}, active ({NELECAS}e,"
          f"{NCAS}o), device {oo.device}")
    print(f"n_theta = {pqc.theta_shape}, n_kappa = {oo.n_kappa}")
    e_zero = float(oo.energy_from_parameters(pqc.init_zeros()))
    print(f"E(theta=0) = {e_zero:.10f}")

    # 3. damped-Newton optimization of (theta, kappa)
    energy_l, _, _, _, hess_eig_l = newton_run(oo, pqc, verbose=1)

    # 4. against CASSCF
    mol.run_casscf(NCAS, NELECAS)
    print(f"\nOO-VQE energy  = {energy_l[-1]:.10f}")
    print(f"CASSCF energy  = {mol.casscf.e_tot:.10f}")
    print(f"difference     = {energy_l[-1] - mol.casscf.e_tot:.2e} Ha")
    print(f"lowest Hessian eigenvalue at minimum: {hess_eig_l[-1]:.3e}")

    # 5. circuit-only (CASCI-style) optimization at the RHF orbitals
    H = cas_hamiltonian(mol, oo)
    energies, _ = adam_run(pqc, H, steps=args.adam_steps)
    mol.run_casci(NCAS, NELECAS, fix_singlet=0)
    print(f"\ncircuit-only (Adam) energy  = {energies[-1]:.10f}")
    print(f"CASCI (any spin) reference  = {mol.casci.e_tot:.10f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
