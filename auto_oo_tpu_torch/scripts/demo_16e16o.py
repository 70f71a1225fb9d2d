"""(16e,16o) on one H100: the full-valence H16 chain, D = C(16,8)^2 = 165.6M.

    python -m auto_oo_tpu_torch.scripts.demo_16e16o [n_layers] [stages]

Port of scripts/demo_16e16o.py, with its argv: the H16 chain
``"; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(16))`` in sto-3g,
sector ``np_fabric`` (n_layers 1 by default), ``freeze_active=True``,
from the demo's theta0 = 0.02 * arange(n_theta).  One f64 state is 1.325
GB and one (n2, D) Phi would be 339 GB, so ``OO_pqc`` takes the hosted
route (models/oo_pqc.py, ops/grid_hosted.py): its per-tangent form in
f64, its Gram form in mixed precision (the (n_theta + 1, D) stack is
19.9 GB in f64, 9.9 GB in f32), as in the JAX package.  Runs on the card
only.

Stages (argv 2, comma-separated, default "state,rdms,s2,energy", the
JAX demo's), each printing its seconds:
  state     circuit state build and its norm
  rdms      restricted RDMs (Phi streamed over grid rows), tr gamma and
            the sum rule
  s2        <S^2> at theta0 through ``Parameterized_circuit.
            s2_expectation`` (the string-factorized S^- on the grid
            state), |<S^2>| < 1e-8, with its peak device memory
  energy    E(theta0), and E(0) against the RHF energy, through
            ``OO_pqc.energy_from_parameters`` (one hosted RDM pass each)
  grad      energy + full gradient at theta0 through
            ``OO_pqc.energy_and_gradient`` (one hosted (H psi, RDMs) pass
            and one adjoint reverse sweep), twice, with |grad|
  gradmixed the same through ``precision="mixed"`` (the pass on the f32
            state, the reverse sweep in f64)
  adam      2 Adam steps of ``OO_pqc.gradient_optimization`` from
            init_zeros (learning rate 0.05, no orbital relaxation), which
            must descend
  adammixed 3 such steps in mixed precision: they must descend to 1e-5,
            and E(0) must equal RHF to 1e-4
  nr        3 second-order damped-Newton iterations from theta0 through
            the hosted route (``OO_pqc._nr_iteration``), f64
  nrmixed   the same through ``precision="mixed"``
"""

import sys
import time

import torch

import auto_oo_tpu_torch as P

GEOMETRY = "; ".join(f"H 0 0 {0.9 * i:.2f}" for i in range(16))
STEP = (1e-4, 0.5, 1e-6, 1.1, 1e-6)   # alpha, beta, mu, rho, lambda_min
_GRAD_STAGES = {"grad": "f64", "gradmixed": "mixed"}
_ADAM_STAGES = {"adam": ("f64", 2), "adammixed": ("mixed", 3)}
_NR_STAGES = {"nr": "f64", "nrmixed": "mixed"}
_STAGES = (("state", "rdms", "s2", "energy") + tuple(_GRAD_STAGES)
           + tuple(_ADAM_STAGES) + tuple(_NR_STAGES))


def _synced(fn):
    """fn() and its seconds on the host clock, ending in a synchronize
    where a card is in use."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else None
    if sync:
        sync()
    t0 = time.perf_counter()
    out = fn()
    if sync:
        sync()
    return out, time.perf_counter() - t0


def grad_stage(pqc, mol, ncas, nelecas, theta, precision,
               check_energy=False):
    """The grad / gradmixed stage: ``energy_and_gradient`` at ``theta``
    through an ``OO_pqc`` of ``precision`` (freeze_active), twice (the
    first call carries the card's start-up), each printed with its
    seconds and |grad|; with ``check_energy`` its energy must equal
    ``energy_from_parameters(theta)`` to 1e-9.  Returns (the OO_pqc, the
    energy, the circuit gradient)."""
    oo = P.OO_pqc(pqc, mol, ncas, nelecas, freeze_active=True,
                  precision=precision)
    for label in ("first", "warm"):
        (e, grad, _), sec = _synced(lambda: oo.energy_and_gradient(theta))
        print(f"energy+gradient ({precision}, {label}): {sec:.2f} s  E = "
              f"{float(e):.10f}  |grad| = {float(grad.norm()):.6e}  "
              f"(route {oo._core['route']})", flush=True)
    if check_energy:
        e_ref = float(oo.energy_from_parameters(theta))
        print(f"E(theta) through energy_from_parameters: {e_ref:.10f}, "
              f"diff {float(e) - e_ref:+.2e}", flush=True)
        assert abs(float(e) - e_ref) < 1e-9, (float(e), e_ref)
    return oo, float(e), grad[:oo._nt]


def adam_stage(pqc, mol, ncas, nelecas, precision, steps):
    """The adam / adammixed stage: ``steps`` Adam steps of
    ``gradient_optimization`` from init_zeros (learning rate 0.05, no
    orbital relaxation) through an ``OO_pqc`` of ``precision``
    (freeze_active), with seconds per step; the energies must descend
    (mixed: to the JAX demo's 1e-5, and E(0), the HF determinant, must
    equal the RHF energy to 1e-4).  Returns (the OO_pqc, the energies)."""
    oo = P.OO_pqc(pqc, mol, ncas, nelecas, freeze_active=True,
                  precision=precision)
    (energy_l, _), sec = _synced(lambda: oo.gradient_optimization(
        pqc.init_zeros(), max_iterations=steps, learning_rate=0.05,
        orbital_every=0, verbose=1))
    n = len(energy_l)
    print(f"{n} Adam steps ({precision}): {sec:.1f} s ({sec / n:.2f} "
          f"s/step)  dE = {energy_l[-1] - energy_l[0]:+.3e} Ha", flush=True)
    mixed = precision == "mixed"
    assert energy_l[-1] <= energy_l[0] + (1e-5 if mixed else 1e-10), energy_l
    if mixed:
        assert abs(energy_l[0] - mol.hf.e_tot) < 1e-4, (energy_l[0],
                                                        mol.hf.e_tot)
    return oo, energy_l


def s2_stage(pqc, theta):
    """The s2 stage: <S^2> at ``theta`` (the grid S^- maps built on first
    use), which must be below 1e-8 in magnitude: the np_fabric circuit
    keeps the singlet.  Prints its seconds and, on the card, the peak
    device memory of the call above what was allocated before it; returns
    (<S^2>, seconds, that peak in bytes or None)."""
    cuda = pqc.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(pqc.device)
        resident = torch.cuda.memory_allocated(pqc.device)
        torch.cuda.reset_peak_memory_stats(pqc.device)
    s2, sec = _synced(lambda: float(pqc.s2_expectation(theta)))
    peak = (torch.cuda.max_memory_allocated(pqc.device) - resident if cuda
            else None)
    shown = "" if peak is None else (f", peak {peak / 1e9:.3f} GB above "
                                     f"the {resident / 1e9:.3f} GB before")
    print(f"<S^2> = {s2:.2e} ({sec:.2f} s incl. grid S^- map build"
          f"{shown})", flush=True)
    assert abs(s2) < 1e-8, s2
    return s2, sec, peak


def state_stages(pqc, mol, ncas, nelecas, theta, stages):
    """The state, rdms, s2 and energy stages of ``stages``: the norm of
    the state at ``theta``, tr gamma and the partial-trace sum rule (to
    1e-8), <S^2> (``s2_stage``), and E(theta) and E(0) through
    ``OO_pqc.energy_from_parameters`` with E(0), the HF determinant,
    equal to the RHF energy to 1e-6."""
    if "state" in stages:
        psi, sec = _synced(lambda: pqc.state(theta))
        nrm = float(psi @ psi)
        print(f"state build: {sec:.2f} s  |psi|^2 = {nrm:.12f}", flush=True)
        assert abs(nrm - 1.0) < 1e-10
        del psi
    if "rdms" in stages:
        (g1, G2), sec = _synced(lambda: pqc.get_rdms(theta))
        tr = float(torch.trace(g1))
        part = torch.einsum("pqrr->pq", G2)
        sum_err = float((part - (nelecas - 1) * g1).abs().max())
        print(f"RDMs: {sec:.2f} s  tr gamma = {tr:.10f}  sum-rule err = "
              f"{sum_err:.1e}", flush=True)
        assert abs(tr - nelecas) < 1e-8 and sum_err < 1e-8
    if "s2" in stages:
        s2_stage(pqc, theta)
    if "energy" in stages:
        oo, sec = _synced(lambda: P.OO_pqc(pqc, mol, ncas, nelecas,
                                           freeze_active=True))
        print(f"OO_pqc setup: {sec:.1f} s (route {oo._core['route']})",
              flush=True)
        e, sec = _synced(lambda: float(oo.energy_from_parameters(theta)))
        print(f"E(theta0) = {e:.10f} Ha ({sec:.2f} s)", flush=True)
        e0, sec = _synced(lambda: float(oo.energy_from_parameters(
            pqc.init_zeros())))
        print(f"E(0) = {e0:.10f} Ha ({sec:.2f} s), RHF {mol.hf.e_tot:.10f},"
              f" diff {e0 - mol.hf.e_tot:+.2e}: the HF determinant in the "
              f"active space", flush=True)
        assert abs(e0 - mol.hf.e_tot) < 1e-6, (e0, mol.hf.e_tot)
        del oo


def check_stages(stages, known=_STAGES):
    """Refuse the stages not in ``known`` before any card is looked
    for."""
    for st in stages:
        if st not in known:
            raise ValueError(f"unknown stage {st!r}")


def nr_stage(pqc, mol, ncas, nelecas, theta, precision, iterations=3):
    """The nr / nrmixed stage: ``iterations`` damped-Newton iterations
    from ``theta`` through an ``OO_pqc`` of ``precision`` (freeze_active),
    each printed with its seconds; the energies must descend (mixed
    energies carry ~1e-6 relative noise, the JAX demo's 1e-5 slack).
    Returns (the OO_pqc, the energies)."""
    oo = P.OO_pqc(pqc, mol, ncas, nelecas, freeze_active=True,
                  precision=precision)
    core = oo._core
    print(f"OO_pqc ({precision}): route {core['route']}, hosted form "
          f"{core['hosted_form']}", flush=True)
    th, oao = theta, oo.oao_mo_coeff
    es = []
    for i in range(iterations):
        (th, _, oao, e, low), sec = _synced(
            lambda: oo._nr_iteration(th, oao, *STEP))
        es.append(float(e))
        print(f"NR iter {i + 1} ({precision}): {sec:.1f} s  E = "
              f"{es[-1]:.10f}  lam0 = {float(low):.3e}", flush=True)
    slack = 1e-5 if precision == "mixed" else 1e-10
    assert es[-1] <= es[0] + slack, es
    return oo, es


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n_layers = int(argv[0]) if argv else 1
    stages = (argv[1] if len(argv) > 1 else "state,rdms,s2,energy").split(
        ",")
    check_stages(stages)
    if not torch.cuda.is_available():
        print("demo_16e16o: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ncas = nelecas = 16
    mol, sec = _synced(lambda: P.Moldata(GEOMETRY, "sto-3g"))
    mol.run_rhf()
    print(f"H16 chain RHF: {mol.hf.e_tot:.8f} Ha ({sec:.1f} s, "
          f"nao={mol.nao})", flush=True)
    pqc, sec = _synced(lambda: P.Parameterized_circuit(
        ncas, nelecas, ansatz="np_fabric", n_layers=n_layers, sector=True))
    print(f"circuit setup: {sec:.1f} s (D={pqc.state_dim:,}, "
          f"n_theta={pqc.theta_shape}, gates={len(pqc.grid_program.gates)})",
          flush=True)
    # no flat program and no D-sized host table: the grid maps and the
    # permutations live on the card
    assert getattr(pqc, "_program", None) is None
    assert pqc._sector_basis is None

    theta = 0.02 * torch.arange(pqc.theta_shape, dtype=torch.float64,
                                device=pqc.device)
    state_stages(pqc, mol, ncas, nelecas, theta, stages)
    for stage, precision in _GRAD_STAGES.items():
        if stage in stages:
            grad_stage(pqc, mol, ncas, nelecas, theta, precision)
            torch.cuda.empty_cache()
    for stage, (precision, steps) in _ADAM_STAGES.items():
        if stage in stages:
            adam_stage(pqc, mol, ncas, nelecas, precision, steps)
            torch.cuda.empty_cache()
    for stage, precision in _NR_STAGES.items():
        if stage in stages:
            nr_stage(pqc, mol, ncas, nelecas, theta, precision)
            torch.cuda.empty_cache()
    print("DEMO OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
