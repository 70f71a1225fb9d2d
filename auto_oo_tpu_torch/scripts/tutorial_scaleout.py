"""Tutorial: OO-VQE over several ranks with torch.distributed.

    torchrun --nproc_per_node=N -m auto_oo_tpu_torch.scripts.tutorial_scaleout
    python -m auto_oo_tpu_torch.scripts.tutorial_scaleout [--ranks N]
        [--device cpu]

Port of examples/tutorial_scaleout.py.  Five parallel axes, formaldimine
sto-3g:

1. the tangent-sharded damped-Newton step ("tp": each rank takes a
   block of the Hessian's tangent rows), (2e,2o) np_fabric L=1 to
   convergence;
2. the forward pass with the state and the ERI transform split over the
   ranks;
3. the geometry batch ("dp": the geometries of a PES scan split over the
   ranks), four geometries;
4. the row-sharded string-grid engine (the (Na, Nb) grid split over
   alpha-string rows) driving first-order OO-VQE on the (4e,4o) sector;
5. the 2-D (tangent x row) second-order engine, 4 Newton steps.

Under ``torchrun`` each rank is a process on its own card (NCCL);
``--ranks N`` spawns N gloo ranks on this machine's CPU
(``parallel.distributed.run_ranks``); with neither, one process makes a
one-rank group on the port's device (the card by default, or
``--device cpu``).  Rank 0 prints.
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.parallel import (GeometryBatch, grid2d_nr_fns,
                                        initialize_distributed, make_mesh,
                                        row_sharded_gradient_optimization,
                                        sharded_energy_fn,
                                        sharded_nr_step_fn)
from auto_oo_tpu_torch.parallel.distributed import run_ranks


def tutorial(rank):
    """The five demos on this rank; returns rank 0's lines."""
    lines = []

    def say(text):
        if rank == 0:
            print(text, flush=True)
        lines.append(text)

    mesh = make_mesh(names=("dp", "tp"))
    n = dist.get_world_size()
    say(f"ranks: {n} ({dist.get_backend()})")
    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    oo = P.OO_pqc(pqc, mol, 2, 2, freeze_active=True)

    # --- 1. sharded Newton-Raphson optimization ---------------------------
    step = sharded_nr_step_fn(oo, mesh, axis="tp")
    theta, oao = pqc.init_zeros(), oo.oao_mo_coeff
    say("sharded NR optimization:")
    e_prev = float("inf")
    for it in range(15):
        theta, _kappa, oao, energy, _lowest = step(theta, oao)
        e = float(energy)
        say(f"  iter {it:2d}  E = {e:.10f}")
        if abs(e - e_prev) < 1e-10:
            break
        e_prev = e

    # --- 2. state + ERI split forward pass ---------------------------------
    e_fn = sharded_energy_fn(oo, mesh, sv_axis="tp", eri_axis="tp")
    e_sh = float(e_fn(theta, torch.zeros(oo.n_kappa, dtype=theta.dtype,
                                         device=theta.device), oao))
    say(f"sharded statevector+ERI energy: {e_sh:.10f}")

    # --- 3. geometry batch over the dp axis --------------------------------
    geos = [P.get_formal_geo(a, p) for a, p in
            [(140, 80), (135, 85), (130, 90), (125, 95)]]
    mols = [P.Moldata(g, "sto-3g") for g in geos]
    dp = max(d for d in (4, 2, 1) if n % d == 0)
    batch = GeometryBatch(mols, 2, 2, pqc, axis="dp",
                          mesh=make_mesh(shape=(dp, n // dp),
                                         names=("dp", "tp")))
    B = len(mols)
    thetas = theta.expand(B, -1)
    kappas = torch.zeros((B, batch.oo0.n_kappa), dtype=theta.dtype,
                         device=theta.device)
    oaos = torch.stack([m.oao_mo_coeff for m in batch.oo_list])
    energies = batch.energies(thetas, kappas, oaos)
    say("geometry batch energies: "
        + " ".join(f"{e:.8f}" for e in energies.tolist()))

    # --- 4. row-sharded string-grid sector engine --------------------------
    pqc_s = P.Parameterized_circuit(4, 4, ansatz="np_fabric", n_layers=4,
                                    sector=True)
    oo_s = P.OO_pqc(pqc_s, mol, 4, 4)
    e_l, _theta_s = row_sharded_gradient_optimization(
        oo_s, mesh, max_iterations=25, learning_rate=0.05,
        orbital_every=10)
    say(f"row-sharded first-order OO-VQE: {len(e_l)} iters, "
        f"E = {e_l[-1]:.10f} (every large-D stage on the mesh)")

    # --- 5. 2-D (tangent x row) sharded second-order engine ----------------
    t = 2 if n % 2 == 0 and n >= 4 else 1
    mesh2 = make_mesh(shape=(t, n // t), names=("tp", "row"))
    oo_2d = P.OO_pqc(pqc_s, mol, 4, 4, freeze_active=True)
    eng = grid2d_nr_fns(oo_2d, mesh2, t_axis="tp", r_axis="row")
    th, oao2 = pqc_s.init_zeros(), oo_2d.oao_mo_coeff
    for it in range(4):
        th, _, oao2, e, lowest = eng["nr_step"](th, oao2)
        say(f"  grid2d NR iter {it}  E = {float(e):.10f}  "
            f"lowest eig = {float(lowest):.3e}")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=None,
                        help="spawn this many gloo ranks on the CPU")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.ranks:
        run_ranks(tutorial, args.ranks)
        return 0
    if args.device:
        config.set_device(args.device)
    if "WORLD_SIZE" in os.environ:
        initialize_distributed()
    try:
        tutorial(dist.get_rank() if dist.is_initialized() else 0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
