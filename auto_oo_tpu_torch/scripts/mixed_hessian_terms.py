"""How much float32 rounding the mixed circuit-Hessian block carries.

    python -m auto_oo_tpu_torch.scripts.mixed_hessian_terms [--device cpu]

On the (10e,10o) slice (formaldimine sto-3g, sector np_fabric L=2,
freeze_active) at a seeded theta, the circuit block of the Hessian is
hess_cc = term1 + term2, term1 = 2 J H J^T and term2 = d^2 <w, psi> / d
theta^2 with w = 2 H psi (models/oo_pqc.py).  Both terms carry the
active-space energy, so they nearly cancel.  The script prints the
active energy <psi|H|psi>, the Frobenius norms of term1, term2 and their
sum, each term's relative error in float32 (J, w, psi and theta cast as
``precision="mixed"`` casts them) against float64, and the relative
error of the mixed grad_hess's circuit block against the f64 one.  These
are properties of the arithmetic, not device timings; the card's default
device is used unless ``--device cpu``.
"""

import argparse
import sys

import numpy as np
import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.ops import hamiltonian as _ham
from auto_oo_tpu_torch.ops import transforms as _tr
from auto_oo_tpu_torch.ops.linalg import gram_last


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mixed_hessian_terms")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=2,
                                  sector=True, device=args.device)
    oo = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True)
    oo_m = P.OO_pqc(pqc, mol, 10, 10, freeze_active=True, precision="mixed")
    nt = pqc.theta_shape
    theta = torch.as_tensor(
        0.05 * np.random.default_rng(1).standard_normal(nt),
        device=pqc.device)
    mo = oo.oao_coeff @ oo.oao_mo_coeff
    h1 = _tr.int1e_transform(oo.int1e_ao, mo)
    g2 = _tr.int2e_transform(oo.int2e_ao, mo)
    _, c1, c2 = _tr.molecular_hamiltonian_coefficients(
        oo.nuc, h1, g2, oo._occ, oo._act)
    c1eff = _ham.c1_effective(c1, c2)
    maps = pqc.sector_maps
    psi, J = pqc._state_and_jacobian_grid(theta)
    Hpsi = _ham.ham_apply(c1eff, c2, psi, 10, maps)
    w = 2.0 * Hpsi
    t1 = 2.0 * J @ _ham.ham_apply(c1eff, c2, J, 10, maps).T
    t1_32 = 2.0 * gram_last(J.float(),
                            _ham.ham_apply(c1eff, c2, J.float(), 10, maps))
    t2 = pqc._state_hessian_dot_grid(theta, w, psi, J)
    t2_32 = pqc._state_hessian_dot_grid(theta.float(), w.float(),
                                        psi.float(), J.float())
    h = oo._grad_hess(theta)[2][:nt, :nt]
    h_m = oo_m._grad_hess(theta)[2][:nt, :nt]
    print(f"device {pqc.device}; active energy <psi|H|psi> "
          f"{float(psi @ Hpsi):.6f} Ha")
    print(f"|term1| {float(t1.norm()):.6f}  |term2| {float(t2.norm()):.6f}"
          f"  |term1 + term2| {float((t1 + t2).norm()):.6f}")
    print(f"f32 relative error: term1 {_rel(t1_32, t1):.3e}, term2 "
          f"{_rel(t2_32, t2):.3e}; the mixed grad_hess's circuit block "
          f"{_rel(h_m, h):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
