"""The hydrogen-chain problem: a linear chain of H atoms in STO-3G, every
orbital active and frozen (no orbital rotation), one ``OO_pqc`` driven
through ``full_optimization`` (damped Newton) or
``gradient_optimization`` (Adam), and its plain reference
(``benchmark/reference/problem.py``).

A configuration names it with ``"problem": "hchain"``; the harness loads
this file by path and calls the functions below (``benchmark/README.md``
has the contract).  The port is imported only inside the program's
functions; the reference side imports nothing of it.
"""

import contextlib

import numpy as np
import torch

from benchmark import counts, harness
from benchmark.reference import chem
from benchmark.reference.problem import Reference


class Inputs:
    """What the seed draws, the same for the program and the reference:
    the chain's uniform spacing (a point of a PES scan), its geometry
    string, the start angles, and the sign-fixed RHF orbitals that both
    sides' circuits are written in."""

    def __init__(self, cell, seed):
        cfg, tr = cell.config, cell.traffic
        rng = np.random.default_rng(int(seed))
        lo, hi = tr["spacing_angstrom"]
        self.spacing = round(float(rng.uniform(lo, hi)), 6)
        self.geometry = chem.chain_geometry(cfg["atoms"], self.spacing)
        lo, hi = tr["theta0"]
        self.theta0 = rng.uniform(lo, hi, cfg["n_theta"])
        S, hcore, eri, _ = chem.integrals(self.geometry)
        self.mo_coeff = chem.fix_signs(
            chem.rhf(S, hcore, eri, cfg["nelecas"])[1])
        self.describe = f"spacing {self.spacing} A"


class Program:
    """The port, built for one cell and driven through ``OO_pqc``'s
    ``full_optimization`` (damped Newton) or ``gradient_optimization``
    (Adam)."""

    def __init__(self, cell, inputs, device):
        import auto_oo_tpu_torch as P
        from auto_oo_tpu_torch.models.oo_energy import mo_ao_to_mo_oao
        cfg = cell.config
        self.cell = cell
        self.mol = P.Moldata(inputs.geometry, cfg["basis"])
        self.pqc = P.Parameterized_circuit(
            cfg["ncas"], cfg["nelecas"], ansatz=cfg["ansatz"],
            n_layers=cfg["n_layers"], sector=True, device=device)
        if int(self.pqc.theta_shape) != cfg["n_theta"]:
            raise ValueError(f"{cfg['name']}: the circuit has "
                             f"{self.pqc.theta_shape} angles, the "
                             f"configuration states {cfg['n_theta']}")
        oao = mo_ao_to_mo_oao(inputs.mo_coeff, self.mol.overlap)
        self.oo = P.OO_pqc(self.pqc, self.mol, cfg["ncas"], cfg["nelecas"],
                           oao_mo_coeff=oao,
                           freeze_active=cfg["freeze_active"],
                           precision=cfg["precision"])
        self.oao0 = self.oo.oao_mo_coeff.clone()
        self.theta0 = torch.as_tensor(inputs.theta0, dtype=torch.float64,
                                      device=device)
        self.route = self.oo._core["route"]
        self.shapes = (cfg["ncas"], int(self.pqc.state_dim),
                       int(self.pqc.theta_shape), int(self.oo.n_kappa),
                       int(self.oo.nao),
                       len(self.oo._occ) + len(self.oo._act),
                       counts.pairs_per_apply(cfg["ncas"], cfg["n_layers"]))

    @property
    def parts(self):
        """The Newton core's part timer."""
        return self.oo._core["parts"]

    def solve(self, steps, monitor=None):
        """One solve of ``steps`` from the seeded start, as a user runs it:
        no convergence stop (a negative tolerance)."""
        tr = self.cell.traffic
        self.oo.oao_mo_coeff = self.oao0.clone()
        if tr["optimizer"] == "newton":
            self.oo.full_optimization(
                self.theta0, max_iterations=steps, conv_tol=-1.0,
                alpha=tr["alpha"], beta=tr["beta"], mu=tr["mu"],
                rho=tr["rho"], lambda_min=tr["lambda_min"], monitor=monitor)
        elif tr["optimizer"] == "adam":
            self.oo.gradient_optimization(
                self.theta0, max_iterations=steps,
                learning_rate=tr["learning_rate"], conv_tol=-1.0,
                orbital_every=0, monitor=monitor)
        else:
            raise ValueError(f"unknown optimizer {tr['optimizer']!r}")

    @contextlib.contextmanager
    def hook(self, rec):
        """The recorders' hooks on this program's instances (the port is
        not edited), removed on exit:

        * the iterate and gradient of each step (``OO_pqc._nr_iteration``,
          ``OO_pqc.energy_and_gradient``), kept in ``rec.pending`` as
          references;
        * the energy evaluations (``Parameterized_circuit.
          _state_impl_grid``, one per trial energy of a line search and
          per gradient step), counted in ``rec.evaluations``."""
        oo, pqc = self.oo, self.pqc
        nr, eg, st = oo._nr_iteration, oo.energy_and_gradient, \
            pqc._state_impl_grid

        def nr_iteration(theta, oao, *args):
            out = nr(theta, oao, *args)
            rec.pending["theta"] = out[0]
            return out

        def energy_and_gradient(theta):
            out = eg(theta)
            rec.pending["theta"], rec.pending["grad"] = theta, out[1]
            return out

        def state(theta):
            rec.evaluations += 1
            return st(theta)

        oo._nr_iteration = nr_iteration
        oo.energy_and_gradient = energy_and_gradient
        pqc._state_impl_grid = state
        try:
            yield
        finally:
            # the instance attributes go; the class's methods show again
            del oo._nr_iteration, oo.energy_and_gradient
            del pqc._state_impl_grid


#: the contract's ``inputs(cell, seed)`` and ``build(cell, inputs, device)``
inputs = Inputs
build = Program


def program_trajectory(run):
    """The program's Trajectory: every solve's first steps, in every
    stretch; the angles and gradient of the window's first solve."""
    cell = run.cell
    k = int(cell.traffic["checked_steps"])
    first = [s for s in run.steps if s.stretch == 0 and s.solve == 0]
    held = [s for s in run.steps if s.index < k]
    newton = cell.traffic["optimizer"] == "newton"
    theta = (first[k - 1] if newton else first[k]).theta
    grad = None if newton else first[0].grad[:cell.config["n_theta"]]
    return harness.Trajectory(
        [(s.index, s.energy) for s in held],
        theta.double().cpu().numpy(),
        [(s.index, s.lowest) for s in held] if newton else (),
        None if grad is None else grad.double().cpu().numpy())


def reference_trajectory(cell, inputs, device, dtype=torch.float64):
    """The plain reference's Trajectory from the same inputs, computed in
    ``dtype`` (float32: the control)."""
    cfg, tr = cell.config, cell.traffic
    k = int(tr["checked_steps"])
    ref = Reference(inputs.geometry, cfg["ncas"], cfg["n_layers"], device,
                    dtype)
    theta0 = np.asarray(inputs.theta0, dtype=np.float64)
    if tr["optimizer"] == "newton":
        out = ref.newton(theta0, k, tr["alpha"], tr["beta"], tr["mu"],
                         tr["rho"], tr["lambda_min"])
        return harness.Trajectory(enumerate(o[1] for o in out),
                                  out[-1][0].numpy(),
                                  enumerate(o[2] for o in out))
    energies, grad, theta = ref.adam(theta0, k, tr["learning_rate"])
    return harness.Trajectory(enumerate(energies), theta, grad=grad)


def step_flops(cell, shapes, trials):
    """One step's frozen FLOP count: a damped-Newton iteration with its
    ``trials`` Armijo trials, or a gradient step."""
    if cell.traffic["optimizer"] == "newton":
        return counts.nr_iteration_flops(shapes, trials)
    return counts.grad_step_flops(shapes)
