"""(14e,14o) on one H100: the full-valence H14 chain, D = C(14,7)^2 = 11.78M.

    python -m auto_oo_tpu_torch.scripts.demo_14e14o [n_layers] [stages]

Port of scripts/demo_14e14o.py: the H14 chain
``"; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(14))`` in sto-3g,
sector ``np_fabric`` (n_layers 1 by default), ``freeze_active=True``,
from theta0 = 0.02 * arange(n_theta).  One f64 state is 94 MB and one
(n2, D) Phi would be 18.5 GB, so ``OO_pqc`` takes the streamed route
(Phi streamed over grid rows, ops/grid.py).  Runs on the card only.

Stages (argv 2, comma-separated, default
"state,rdms,s2,energy,grad,adam"), each printing its seconds, with the
argv scheme of demo_16e16o:
  state   circuit state build and its norm
  rdms    restricted RDMs, tr gamma and the sum rule (to 1e-8)
  s2      <S^2> at theta0 on the grid, |<S^2>| < 1e-8 (the JAX demo's
          check), with its peak device memory
  energy  E(theta0), and E(0) against the RHF energy (to 1e-6)
  grad    energy + full gradient at theta0 (``energy_and_gradient``:
          one H-apply, one adjoint reverse sweep, the RDMs), twice; its
          energy must equal E(theta0) to 1e-9
  adam    3 Adam steps of ``gradient_optimization`` from init_zeros
          (learning rate 0.05, no orbital relaxation), which must descend

The flat gate program is never built.
"""

import sys

import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.scripts.demo_16e16o import (
    _synced, adam_stage, check_stages, grad_stage, state_stages)

GEOMETRY = "; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(14))
_STAGES = ("state", "rdms", "s2", "energy", "grad", "adam")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_layers = int(argv[0]) if argv else 1
    stages = (argv[1] if len(argv) > 1 else ",".join(_STAGES)).split(",")
    check_stages(stages, _STAGES)
    if not torch.cuda.is_available():
        print("demo_14e14o: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ncas = nelecas = 14
    mol, sec = _synced(lambda: P.Moldata(GEOMETRY, "sto-3g"))
    mol.run_rhf()
    print(f"H14 chain RHF: {mol.hf.e_tot:.8f} Ha ({sec:.1f} s, "
          f"nao={mol.nao})", flush=True)
    pqc, sec = _synced(lambda: P.Parameterized_circuit(
        ncas, nelecas, ansatz="np_fabric", n_layers=n_layers, sector=True))
    print(f"circuit setup: {sec:.1f} s (D={pqc.state_dim:,}, "
          f"n_theta={pqc.theta_shape}, gates={len(pqc.grid_program.gates)})",
          flush=True)
    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device=pqc.device)
    state_stages(pqc, mol, ncas, nelecas, theta, stages)
    if "grad" in stages:
        grad_stage(pqc, mol, ncas, nelecas, theta, "f64", check_energy=True)
    if "adam" in stages:
        adam_stage(pqc, mol, ncas, nelecas, "f64", 3)
    # the flat program (O(n_gates * D) tables) was never built
    assert pqc._program is None
    print("DEMO OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
