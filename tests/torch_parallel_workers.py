"""The rank side of tests/test_torch_parallel.py and
tests/test_torch_row_sharded.py: each case runs on every rank of one
spawned gloo world (``parallel.distributed.run_ranks``) and returns its
results as numpy arrays.  This module imports no JAX: the parent pytest
process computes the JAX references and passes the cases' inputs in as
numpy arrays.
"""

import numpy as np
import torch

STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _mol():
    import auto_oo_tpu_torch as P
    return P.Moldata(P.get_formal_geo(140, 80), "sto-3g")


def _sector(ncas, nelecas, n_layers=2):
    import auto_oo_tpu_torch as P
    return P.Parameterized_circuit(ncas, nelecas, ansatz="np_fabric",
                                   n_layers=n_layers, sector=True)


def run_cases(rank, cases):
    """Run ``cases`` [(name, function name, inputs), ...] in order on this
    rank; returns {name: results}."""
    return {name: _np(globals()[fn](**inputs)) for name, fn, inputs in cases}


# ---- the row-sharded engines (tests/test_torch_row_sharded.py) -------------


def row_engine(ncas, nelecas, theta, psi, c0, c1eff, c2, block_bytes=None):
    from auto_oo_tpu_torch.parallel import grid_sharded as gs, make_mesh

    pqc = _sector(ncas, nelecas)
    mesh = make_mesh(names=("dp", "tp"))
    saved = gs._LOCAL_BLOCK_BYTES
    if block_bytes is not None:
        gs._LOCAL_BLOCK_BYTES = block_bytes
    try:
        eng = gs.row_sharded_sector_fns(pqc, mesh, axis="tp")
        psi, c0, c1eff, c2 = (_t(psi), float(c0), _t(c1eff), _t(c2))
        out = {"rdms": eng["rdms"](psi),
               "ham": eng["ham_apply"](c1eff, c2, psi),
               "energy": eng["energy"](c0, c1eff, c2, psi)}
        if block_bytes is None:
            e0, grad, psi_g = eng["energy_gradient_psi"](c0, c1eff, c2,
                                                         _t(theta))
            out.update(eg=(e0, grad), state=eng["state"](_t(theta)),
                       rdms_grid=eng["rdms_grid"](psi_g))
    finally:
        gs._LOCAL_BLOCK_BYTES = saved
    return out


def row_engine_complex(psi, c0, c1eff, c2):
    from auto_oo_tpu_torch.parallel import make_mesh, row_sharded_sector_fns

    pqc = _sector(4, 4)
    mesh = make_mesh(names=("dp", "tp"))
    eng = row_sharded_sector_fns(pqc, mesh, axis="tp",
                                 dtype=torch.complex128)
    psi, c1eff, c2 = _t(psi), _t(c1eff), _t(c2)
    gamma, Gamma = eng["rdms"](psi)
    try:
        row_sharded_sector_fns(pqc, mesh, axis="tp")["rdms"](psi)
        refused = ""
    except TypeError as exc:
        refused = str(exc)
    return {"rdms": (gamma, Gamma), "rdm_dtype": str(gamma.dtype),
            "ham": eng["ham_apply"](c1eff, c2, psi),
            "energy": eng["energy"](float(c0), c1eff, c2, psi),
            "refused": refused}


def hosted(ncas, nelecas, psi, c1eff, c2, row_chunk):
    from auto_oo_tpu_torch.ops import grid
    from auto_oo_tpu_torch.parallel import hosted_sharded_fns, make_mesh

    gm = grid.build_grid_maps(ncas, nelecas)
    fns = hosted_sharded_fns(gm, make_mesh(names=("row",)),
                             row_chunk=row_chunk)
    xn = fns["rows"](_t(psi))
    h_rows = fns["ham_apply"](_t(c1eff), _t(c2), xn)
    return {"rdms": fns["rdms"](xn), "ham": fns["gather"](h_rows),
            "ham_rows": h_rows, "budget8": fns["memory_budget"](8),
            "row_chunk": fns["row_chunk"]}


def gradient_opt(iterations, orbital_every):
    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.parallel import (make_mesh,
                                            row_sharded_gradient_optimization)

    pqc = _sector(4, 4)
    e_l, theta = row_sharded_gradient_optimization(
        P.OO_pqc(pqc, _mol(), 4, 4), make_mesh(names=("dp", "tp")),
        max_iterations=iterations, learning_rate=0.05,
        orbital_every=orbital_every)
    return {"energies": np.asarray(e_l), "theta": theta}


def grid2d(nelecas, theta):
    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.parallel import grid2d_nr_fns, make_mesh

    pqc = _sector(4, nelecas)
    oo = P.OO_pqc(pqc, _mol(), 4, nelecas, freeze_active=True)
    eng = grid2d_nr_fns(oo, make_mesh(shape=(2, 2), names=("tp", "row")),
                        t_axis="tp", r_axis="row")
    theta = _t(theta)
    kappa = torch.zeros(oo.n_kappa, dtype=torch.float64)
    return {"grad_hess": eng["grad_hess"](theta, oo.oao_mo_coeff),
            "energy": eng["energy"](theta, kappa, oo.oao_mo_coeff),
            "nr_step": eng["nr_step"](theta, oo.oao_mo_coeff)}


# ---- meshes, the tangent-sharded core, statevector / ERI sharding and the
# geometry batch (tests/test_torch_parallel.py) ------------------------------


def mesh_layout():
    import torch.distributed as dist

    from auto_oo_tpu_torch.parallel import distributed as D, make_mesh

    mesh = make_mesh(shape=(2, 2), names=("dp", "tp"))
    ax = {n: D.Axis(mesh, n) for n in ("dp", "tp")}
    D.reset_collectives()
    x = torch.full((3,), float(dist.get_rank()), dtype=torch.float64)
    gathered = D.all_gather(x, ax["tp"])
    summed = D.all_reduce(x.clone(), ax["dp"])
    scattered = D.reduce_scatter(torch.arange(4.0, dtype=torch.float64),
                                 ax["tp"])
    swapped = D.all_to_all(torch.arange(2.0, dtype=torch.float64)
                           + 10 * dist.get_rank(), ax["dp"])
    try:
        D.Axis(mesh, "row")
        bad = ""
    except ValueError as exc:
        bad = str(exc)
    return {"names": mesh.mesh_dim_names, "backend": dist.get_backend(),
            "world": dist.get_world_size(), "rank": dist.get_rank(),
            "sizes": (ax["dp"].size, ax["tp"].size),
            "local": (ax["dp"].rank, ax["tp"].rank),
            "gathered": gathered, "summed": summed, "scattered": scattered,
            "swapped": swapped,
            "counts": {k: tuple(v) for k, v in D.COLLECTIVES.items()},
            "bad_axis": bad}


def _oo(ncas, nelecas, sector=False, n_layers=1):
    import auto_oo_tpu_torch as P

    pqc = P.Parameterized_circuit(ncas, nelecas, ansatz="np_fabric",
                                  n_layers=n_layers, sector=sector)
    return pqc, P.OO_pqc(pqc, _mol(), ncas, nelecas, freeze_active=True)


def tangent_core(ncas, sector, theta, shape, names, state_axis=None,
                 n_layers=1):
    from auto_oo_tpu_torch.parallel import (make_mesh, sharded_grad_hess_fn,
                                            sharded_nr_step_fn)

    pqc, oo = _oo(ncas, ncas, sector, n_layers)
    mesh = make_mesh(shape=shape, names=names)
    theta = _t(theta)
    gh = sharded_grad_hess_fn(oo, mesh, axis="tp", state_axis=state_axis)(
        theta, oo.oao_mo_coeff)
    step = sharded_nr_step_fn(oo, mesh, axis="tp", state_axis=state_axis)(
        theta, oo.oao_mo_coeff)
    return {"grad_hess": gh, "nr_step": step,
            "flat_program": pqc._program is not None}


def full_hessian(theta):
    from auto_oo_tpu_torch.parallel import make_mesh, sharded_full_hessian_fn

    _pqc, oo = _oo(2, 2)
    return {"hess": sharded_full_hessian_fn(
        oo, make_mesh(names=("dp", "tp")), axis="tp")(_t(theta),
                                                      oo.oao_mo_coeff)}


def statevector(theta, int2e, mo, kappa):
    from auto_oo_tpu_torch.parallel import (make_mesh, sharded_energy_fn,
                                            sharded_int2e_transform_fn,
                                            sharded_rdms_fn,
                                            sharded_state_fn)

    mesh = make_mesh(names=("dp", "tp"))
    pqc, oo = _oo(2, 2)
    theta = _t(theta)
    sector = _sector(4, 4)
    theta4 = 0.05 * torch.arange(sector.theta_shape, dtype=torch.float64)
    try:
        sharded_rdms_fn(pqc, mesh, shard_gates=True)
        gates_refused = ""
    except NotImplementedError as exc:
        gates_refused = str(exc)
    return {"state_block": sharded_state_fn(pqc, mesh)(theta),
            "gates_refused": gates_refused,
            "rdms": sharded_rdms_fn(pqc, mesh)(theta),
            "rdms_sector": sharded_rdms_fn(sector, mesh,
                                           shard_gates=False)(theta4),
            "int2e": sharded_int2e_transform_fn(mesh)(_t(int2e), _t(mo)),
            "energy": sharded_energy_fn(oo, mesh)(theta, _t(kappa),
                                                  oo.oao_mo_coeff)}


def geometry_batch(geos, thetas, kappas):
    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.parallel import GeometryBatch, make_mesh

    mols = [P.Moldata(P.get_formal_geo(a, p), "sto-3g") for a, p in geos]
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    batch = GeometryBatch(mols, 2, 2, pqc, mesh=make_mesh(names=("dp",)))
    oaos = torch.stack([oo.oao_mo_coeff for oo in batch.oo_list])
    thetas, kappas = _t(thetas), _t(kappas)
    return {"lanes": (batch._lanes.start, batch._lanes.stop),
            "energies": batch.energies(thetas, kappas, oaos),
            "gradients": batch.gradients(thetas, kappas, oaos),
            "newton_steps": batch.newton_steps(pqc.init_zeros(), oaos),
            "device_loop": batch.optimize_device_loop(
                pqc.init_zeros(), max_steps=6, conv_tol=0.0)}


def run_batched(geos):
    import auto_oo_tpu_torch as P
    from auto_oo_tpu_torch.parallel import make_mesh

    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    geometries = [P.get_formal_geo(a, p) for a, p in geos]
    loop = P.BerryPhaseLoop(geometries, "sto-3g", 2, 2, pqc).run_batched(
        conv_tol=1e-10, track_steps=4, mesh=make_mesh(names=("dp",)))
    return {"energies": np.asarray(loop.energy_l),
            "eigs": np.asarray(loop.hess_eig_l)}
