"""Multi-rank dry run of the port's distributed engines on the CPU.

    python -m auto_oo_tpu_torch.scripts.dryrun_multichip [--ranks N]

Port of the JAX package's ``__graft_entry__.dryrun_multichip`` (its
virtual n-device mesh becomes N spawned gloo ranks, default 8): formaldimine
sto-3g, every check of the JAX run with its bound, and rank 0 prints its
lines (the JAX run's own at 8 devices are in MULTICHIP_r05.json):

* (8e,8o) full space np_fabric L=1: the tangent-sharded quadratic-form
  grad+Hessian (tangents and state on one axis, which the tangents keep)
  equal to one rank's within 1e-9; one sharded NR step equal to one
  rank's and to the JAX run's E = -92.6688074620 within 1e-9;
* the (8e,8o) sector NR step on the grid kernels (no flat program
  built);
* the (2e,2o) forward pass with the state and the ERI transform split;
* (10e,10o) sector: the split forward RDMs (trace 10, partial-trace sum
  rule), the row-sharded engine's RDMs against them and against one
  rank's, its energy + adjoint gradient;
* the (8e,8o) sector 2-D (tangent x row) NR step, for N >= 4;
* the hosted x row-sharded engine at (6e,6o) (row_chunk 3) against one
  rank's grid kernels within 1e-11, and the (18e,18o) per-rank memory
  table of its row_chunk policy;
* the (12e,12o) sector forward on rank 0 alone (D = 853,776), as the JAX
  run took it on one device, with <S^2> at (12e,12o) and (10e,10o).
"""

import argparse
import math
import sys

import numpy as np
import torch

# the JAX run's energy after the (8e,8o) sharded NR step (MULTICHIP_r05.json)
E_NR_8E8O = -92.6688074620
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)


def budget_18e18o(n_dev, itemsize=8):
    """The (18e,18o) per-rank bytes of ``hosted_sharded_fns``'
    ``memory_budget`` from the sector's dimensions alone (its maps take
    minutes to build on a host): the same row_chunk policy, D = C(18,9)^2."""
    na = math.comb(18, 9)
    n2 = 18 * 18
    rows = -(-na // n_dev)
    row_chunk = min(rows, max(1, int(1.5e9 // (4 * n2 * na * itemsize))))
    state = rows * na * itemsize
    chunk_block = n2 * row_chunk * na * itemsize
    return {"D": na * na, "state": state, "chunk_block": chunk_block,
            "total_est": 4 * state + 4 * chunk_block}


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def dryrun(rank):
    """Every check on this rank (each rank issues the same collectives);
    returns rank 0's lines."""
    import torch.distributed as dist

    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.ops import grid as G
    from auto_oo_tpu_torch.ops import hamiltonian as H
    from auto_oo_tpu_torch.ops import rdms as R
    from auto_oo_tpu_torch.parallel import (grid2d_nr_fns,
                                            hosted_sharded_fns, make_mesh,
                                            row_sharded_sector_fns,
                                            sharded_energy_fn,
                                            sharded_grad_hess_fn,
                                            sharded_nr_step_fn,
                                            sharded_rdms_fn)

    lines = []
    n = dist.get_world_size()

    def say(text):
        lines.append(f"dryrun_multichip(n={n}): {text}")

    def mx(a, b):
        return float((a - b).abs().max())

    mol = P.Moldata(P.get_formal_geo(140, 80), "sto-3g")
    mesh = make_mesh(shape=(1, n), names=("dp", "tp"))

    pqc = P.Parameterized_circuit(8, 8, ansatz="np_fabric", n_layers=1)
    oo = P.OO_pqc(pqc, mol, 8, 8, freeze_active=True)
    theta = pqc.init_zeros()
    e_s, g_s, h_s = sharded_grad_hess_fn(oo, mesh, axis="tp",
                                         state_axis="tp")(
        theta, oo.oao_mo_coeff)
    e_r, g_r, h_r = oo._grad_hess(theta)
    de, dg, dh = float(abs(e_s - e_r)), mx(g_s, g_r), mx(h_s, h_r)
    _check(max(de, dg, dh) < 1e-9, (de, dg, dh))
    say(f"(8e,8o) sharded quadratic-form grad+Hessian == single-device "
        f"(dE={de:.1e}, dgrad={dg:.1e}, dhess={dh:.1e})")

    step = sharded_nr_step_fn(oo, mesh, axis="tp", state_axis="tp")
    out = step(theta, oo.oao_mo_coeff)
    ref = oo._nr_iteration(theta, oo.oao_mo_coeff, *STEP)
    e = float(out[3])
    _check(np.isfinite(e) and abs(e - float(ref[3])) < 1e-9,
           (e, float(ref[3])))
    _check(abs(e - E_NR_8E8O) < 1e-9, (e, E_NR_8E8O))
    say(f"(8e,8o) sharded NR step ok, E = {e:.10f} (== single-device), "
        f"lowest Hessian eig = {float(out[4]):.3e}")

    pqc8s = P.Parameterized_circuit(8, 8, ansatz="np_fabric", n_layers=1,
                                    sector=True)
    oo8s = P.OO_pqc(pqc8s, mol, 8, 8, freeze_active=True)
    th8 = pqc8s.init_zeros()
    out_s = sharded_nr_step_fn(oo8s, mesh, axis="tp")(th8,
                                                      oo8s.oao_mo_coeff)
    ref_s = oo8s._nr_iteration(th8, oo8s.oao_mo_coeff, *STEP)
    _check(pqc8s._program is None,
           "the grid-sharded sector path built the flat program")
    d_es = float(abs(out_s[3] - ref_s[3]))
    _check(d_es < 1e-9, d_es)
    say(f"(8e,8o) SECTOR grid-sharded NR step ok (D = {pqc8s.state_dim}, "
        f"E = {float(out_s[3]):.10f} == single-device, no flat tables "
        f"built)")

    pqc2 = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    oo2 = P.OO_pqc(pqc2, mol, 2, 2, freeze_active=True)
    zeros = torch.zeros(oo2.n_kappa, dtype=torch.float64)
    e_sh = float(sharded_energy_fn(oo2, mesh, sv_axis="tp", eri_axis="tp")(
        pqc2.init_zeros(), zeros, oo2.oao_mo_coeff))
    e_ref2 = float(oo2.energy_from_parameters(pqc2.init_zeros()))
    _check(abs(e_sh - e_ref2) < 1e-9, (e_sh, e_ref2))
    say(f"sharded-statevector + sharded-ERI forward pass ok, "
        f"E = {e_sh:.10f}")

    pqc10 = P.Parameterized_circuit(10, 10, ansatz="np_fabric", n_layers=1,
                                    sector=True)
    theta10 = 0.01 * torch.arange(pqc10.theta_shape, dtype=torch.float64)
    g10, G10 = sharded_rdms_fn(pqc10, mesh, axis="tp",
                               shard_gates=False)(theta10)
    tr = float(torch.trace(g10))
    err = mx(torch.einsum("pqrr->pq", G10), 9.0 * g10)
    _check(abs(tr - 10.0) < 1e-8 and err < 1e-8, (tr, err))
    say(f"(10e,10o) sector sharded forward ok (D = {pqc10.state_dim}, "
        f"tr gamma = {tr:.10f}, sum-rule err = {err:.1e})")

    eng10 = row_sharded_sector_fns(pqc10, mesh, axis="tp")
    psi10 = pqc10.state(theta10)
    g10r, G10r = eng10["rdms"](psi10)
    d_split = max(mx(g10r, g10), mx(G10r, G10))
    g1d, G1d = pqc10.get_rdms(theta10)
    d_one = max(mx(g10r, g1d), mx(G10r, G1d))
    _check(d_split < 1e-9 and d_one < 1e-9, (d_split, d_one))
    say(f"(10e,10o) ROW-SHARDED grid engine ok (RDMs == split forward to "
        f"{d_split:.1e}, == single-device to {d_one:.1e}; alpha rows "
        f"{pqc10.sector_maps.Na} over {n} ranks)")

    oo10 = P.OO_pqc(pqc10, mol, 10, 10, freeze_active=True)
    c0, c1, c2 = oo10.get_active_integrals(oo10.mo_coeff)
    e10, grad10 = eng10["energy_gradient"](c0, H.c1_effective(c1, c2), c2,
                                           theta10)
    e10_ref, grad_ref = oo10.energy_and_gradient(theta10)[:2]
    d_e10 = float(abs(e10 - e10_ref))
    d_gr = mx(grad10, grad_ref[:pqc10.theta_shape])
    _check(d_e10 < 1e-9 and d_gr < 1e-8, (d_e10, d_gr))
    say(f"(10e,10o) row-sharded adjoint energy+gradient ok "
        f"(dE = {d_e10:.1e}, dgrad = {d_gr:.1e})")

    if n >= 4 and n % 2 == 0:
        mesh2d = make_mesh(shape=(2, n // 2), names=("tp", "row"))
        out2d = grid2d_nr_fns(oo8s, mesh2d, t_axis="tp", r_axis="row")[
            "nr_step"](th8, oo8s.oao_mo_coeff)
        d_e2d = float(abs(out2d[3] - ref_s[3]))
        _check(d_e2d < 1e-9, d_e2d)
        say(f"(8e,8o) grid2d TANGENT x ROW NR step ok "
            f"(E = {float(out2d[3]):.10f} == single-device, mesh 2 x "
            f"{n // 2})")

    gm6 = G.build_grid_maps(6, 6)
    hs = hosted_sharded_fns(gm6, make_mesh(shape=(n,), names=("row",)),
                            row_chunk=3)
    rng = np.random.RandomState(7)
    x6 = torch.as_tensor(rng.randn(gm6.dim))
    x6 = x6 / x6.norm()
    c1_6 = torch.as_tensor(rng.randn(6, 6))
    c1_6 = c1_6 + c1_6.T
    c2_6 = torch.as_tensor(rng.randn(6, 6, 6, 6))
    c2_6 = 0.5 * (c2_6 + c2_6.permute(1, 0, 3, 2))
    c1e_6 = H.c1_effective(c1_6, c2_6)
    x6_rows = hs["rows"](x6)
    g6, G6 = G.assemble_rdms(*hs["rdms"](x6_rows), 6)
    g6r, G6r = R.rdms_from_state(x6, 6, gm6, grid_order=True)
    h6 = hs["gather"](hs["ham_apply"](c1e_6, c2_6, x6_rows))
    h6r = H.ham_apply(c1e_6, c2_6, x6, 6, gm6)
    d_hs = max(mx(g6, g6r), mx(G6, G6r), mx(h6, h6r))
    _check(d_hs < 1e-11, d_hs)
    b = budget_18e18o(n)
    say(f"HOSTED x ROW-SHARDED engine ok at (6e,6o) (RDMs+H-apply == "
        f"single-device to {d_hs:.1e}); (18e,18o) budget on {n} devices "
        f"(engine row_chunk policy): x/out 4 x {b['state'] / 1e9:.2f} GB "
        f"+ ~4 chunk blocks {b['chunk_block'] / 1e9:.2f} GB = "
        f"~{b['total_est'] / 1e9:.1f} GB/device (D = {b['D']:,})")

    if rank == 0:
        pqc12 = P.Parameterized_circuit(12, 12, ansatz="np_fabric",
                                        n_layers=1, sector=True)
        theta12 = 0.01 * torch.arange(pqc12.theta_shape,
                                      dtype=torch.float64)
        g12, G12 = pqc12.get_rdms(theta12)
        tr12 = float(torch.trace(g12))
        err12 = mx(torch.einsum("pqrr->pq", G12), 11.0 * g12)
        _check(abs(tr12 - 12.0) < 1e-8 and err12 < 1e-8, (tr12, err12))
        s2_12 = float(pqc12.s2_expectation(theta12))
        s2_10 = float(pqc10.s2_expectation(theta10))
        _check(abs(s2_12) < 1e-8 and abs(s2_10) < 1e-8, (s2_12, s2_10))
        say(f"(12e,12o) sector forward ok (D = {pqc12.state_dim}, tr gamma "
            f"= {tr12:.10f}, sum-rule err = {err12:.1e}, <S^2> = "
            f"{s2_12:.2e} [10o: {s2_10:.2e}])")
    return lines


def main(argv=None):
    from auto_oo_tpu_torch.parallel.distributed import run_ranks

    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=8)
    args = parser.parse_args(argv)
    for line in run_ranks(dryrun, args.ranks, timeout=3000)[0]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
