"""Berry phase around the formaldimine conical intersection.

    python -m auto_oo_tpu_torch.scripts.tutorial_berry_phase [--points N]
        [--device cpu]

Port of examples/tutorial_berry_phase.py (the reference's
Tutorial_Berry_phase.ipynb as a script over ``BerryPhaseLoop``): the
loop of origin (130, 89.9) deg and radius 10 deg around the conical
intersection, N points (10 by default, first and last equal),
(2e,2o) np_fabric L=1 in sto-3g with the active-active rotations
frozen, one damped-Newton step of tracking per point.  Prints the
energies beside CASSCF, the successive overlaps, the Berry phase (+-pi
expected) and the lowest Hessian eigenvalues.  Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import sys

import numpy as np

import auto_oo_tpu_torch as P


def loop_geometries(points, origin=(130.0, 89.9), radius=(10.0, 10.0),
                    phase=np.pi / 20):
    """Formaldimine geometries at ``points`` even steps around the loop
    (the tutorial's red loop)."""
    ts = np.linspace(0, 1, points)
    return ts, [P.get_formal_geo(
        origin[0] + radius[0] * np.cos(2 * np.pi * t + phase),
        origin[1] + radius[1] * np.sin(2 * np.pi * t + phase)) for t in ts]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--points", type=int, default=10)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    ts, geometries = loop_geometries(args.points)
    ncas, nelecas = 2, 2
    pqc = P.Parameterized_circuit(ncas, nelecas, ansatz="np_fabric",
                                  n_layers=1, device=args.device)
    loop = P.BerryPhaseLoop(geometries, "sto-3g", ncas, nelecas, pqc,
                            freeze_active=True, run_casscf=True)
    loop.run(conv_tol=1e-10, verbose=1)

    print("\nenergies along the loop (single-NR-step tracking vs CASSCF):")
    for t, e, e_ref in zip(ts, loop.energy_l, loop.casscf_energy_l):
        print(f"  t={t:.3f}  E={e:.8f}  CASSCF={e_ref:.8f}")
    ov = loop.overlaps()
    print("\nsuccessive overlaps <psi_{i+1}|G|psi_i>:")
    for i, o in enumerate(ov):
        print(f"  {i}->{(i + 1) % len(ov)}: {o.real:+.6f}")
    print(f"\nfinal overlap: {ov[-1].real:+.6f}  (~ -1 at a conical "
          "intersection)")
    print(f"Berry phase: {loop.berry_phase():+.6f}  (+-pi expected)")
    print("lowest Hessian eigenvalues:", np.round(loop.hess_eig_l, 6))
    return 0


if __name__ == "__main__":
    sys.exit(main())
