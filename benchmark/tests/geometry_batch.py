"""A problem of another kind, written into a tiny root by the tests as
``problems/<name>.py``: ``lanes`` hydrogen chains at spacings the seed
draws, advanced together by the port's ``GeometryBatch.newton_steps``
(one damped-Newton step of every lane at a time, the lanes folded into
the batched core), each lane in its own sign-fixed RHF orbitals; its
reference is ``reference.problem.Reference``, one per lane.

Its configuration is a hydrogen chain's with ``"lanes"``; its traffic
is a damped-Newton mix.  Nothing of the harness names it.
"""

import contextlib

import numpy as np
import torch

from benchmark import counts, harness
from benchmark.reference import chem
from benchmark.reference.problem import Reference


class Inputs:
    """The lanes' spacings, geometries, start angles (one row a lane) and
    sign-fixed RHF orbitals, drawn from the seed."""

    def __init__(self, cell, seed):
        cfg, tr = cell.config, cell.traffic
        rng = np.random.default_rng(int(seed))
        lo, hi = tr["spacing_angstrom"]
        self.spacings = [round(float(s), 6)
                         for s in rng.uniform(lo, hi, cfg["lanes"])]
        self.geometries = [chem.chain_geometry(cfg["atoms"], s)
                           for s in self.spacings]
        lo, hi = tr["theta0"]
        self.theta0 = rng.uniform(lo, hi, (cfg["lanes"], cfg["n_theta"]))
        self.mo_coeffs = []
        for geo in self.geometries:
            S, hcore, eri, _ = chem.integrals(geo)
            self.mo_coeffs.append(chem.fix_signs(
                chem.rhf(S, hcore, eri, cfg["nelecas"])[1]))
        self.describe = "spacings " + ", ".join(
            str(s) for s in self.spacings) + " A"


class Program:
    """The port's GeometryBatch over the lanes, driven step by step."""

    def __init__(self, cell, inputs, device):
        import auto_oo_tpu_torch as P
        from auto_oo_tpu_torch.models.oo_energy import mo_ao_to_mo_oao
        from auto_oo_tpu_torch.parallel import GeometryBatch
        cfg, tr = cell.config, cell.traffic
        if tr["optimizer"] != "newton":
            raise ValueError("a geometry batch takes damped-Newton steps")
        self.cell = cell
        mols = [P.Moldata(g, cfg["basis"]) for g in inputs.geometries]
        pqc = P.Parameterized_circuit(
            cfg["ncas"], cfg["nelecas"], ansatz=cfg["ansatz"],
            n_layers=cfg["n_layers"], sector=True, device=device)
        self.batch = GeometryBatch(mols, cfg["ncas"], cfg["nelecas"], pqc,
                                   freeze_active=cfg["freeze_active"])
        self.oao0 = torch.as_tensor(np.stack([
            mo_ao_to_mo_oao(C, m.overlap)
            for C, m in zip(inputs.mo_coeffs, mols)]), device=device)
        self.theta0 = torch.as_tensor(inputs.theta0, dtype=torch.float64,
                                      device=device)
        self.route = self.batch._core["route"]
        oo = self.batch.oo0
        self.shapes = (cfg["ncas"], int(pqc.state_dim),
                       int(pqc.theta_shape), int(oo.n_kappa), int(oo.nao),
                       len(oo._occ) + len(oo._act),
                       counts.pairs_per_apply(cfg["ncas"], cfg["n_layers"]))
        self._rec = None

    @property
    def parts(self):
        return self.batch._core["parts"]

    def solve(self, steps, monitor=None):
        tr = self.cell.traffic
        thetas, oaos = self.theta0, self.oao0
        for n in range(steps):
            thetas, _, oaos, energies, lowest = self.batch.newton_steps(
                thetas, oaos, alpha=tr["alpha"], beta=tr["beta"],
                mu=tr["mu"], rho=tr["rho"], lambda_min=tr["lambda_min"])
            if self._rec is not None:
                self._rec.pending["theta"] = thetas
            if monitor is not None:
                monitor.log(n + 1, energies, lowest_hess_eig=lowest)

    @contextlib.contextmanager
    def hook(self, rec):
        """The step's iterate goes to ``rec.pending``; the line search's
        trials are not counted."""
        self._rec = rec
        try:
            yield
        finally:
            self._rec = None


inputs = Inputs
build = Program


def program_trajectory(run):
    k = int(run.cell.traffic["checked_steps"])
    first = [s for s in run.steps if s.stretch == 0 and s.solve == 0]
    held = [s for s in run.steps if s.index < k]
    return harness.Trajectory([(s.index, s.energy) for s in held],
                              first[k - 1].theta.double().cpu().numpy(),
                              [(s.index, s.lowest) for s in held])


def reference_trajectory(cell, inputs, device, dtype=torch.float64):
    cfg, tr = cell.config, cell.traffic
    k = int(tr["checked_steps"])
    outs = [Reference(geo, cfg["ncas"], cfg["n_layers"], device,
                      dtype).newton(theta0, k, tr["alpha"], tr["beta"],
                                    tr["mu"], tr["rho"], tr["lambda_min"])
            for geo, theta0 in zip(inputs.geometries, inputs.theta0)]
    return harness.Trajectory(
        [(i, np.array([out[i][1] for out in outs])) for i in range(k)],
        np.stack([out[-1][0].numpy() for out in outs]),
        [(i, np.array([out[i][2] for out in outs])) for i in range(k)])


def step_flops(cell, shapes, trials):
    """Every lane's damped-Newton iteration, one Armijo trial each (the
    least a step runs; the hook counts none)."""
    return cell.config["lanes"] * counts.nr_iteration_flops(shapes, 1)
