"""Damped / augmented-Hessian Newton-Raphson optimizer.

Port of auto_oo_tpu/utils/newton_raphson.py (reference
utils/newton_raphson.py:16-224):

* the Hessian augmentation H += (mu + rho |l0|) I when the lowest
  eigenvalue l0 < lambda_min;
* the Armijo backtracking line search, as a host loop with one scalar
  sync per trial, with the JAX package's exact semantics: the first trial
  is t = 1.0 exactly, t halves (times beta) up to lmax trials, the
  comparison carries a roundoff slack of 64 eps max(1, |e0|) (or
  ``min_rel_slack`` max(1, |e0|) where that is larger: the hosted route's
  mixed-precision trials), and an exhausted search returns t = 0 and e0;
* ``backtracking_batched``: the same search over a batch of lanes (the
  geometries of a batch, or the one run of a device loop), decided on the
  device: the trial energies of K trials per lane come from one energy
  call per round, each lane takes its first accepted trial by an argmax
  over its acceptance mask, and the host reads at most one flag per
  round (none with one round of K = lmax): the JAX package's
  ``lax.while_loop`` under ``vmap``, lanes in lockstep;
* the lowest Hessian eigenvalue is returned (a physics observable tracked
  through Berry-phase loops);
* ``method`` picks the solve: "eigh" or "iterative"
  (ops/linalg.newton_dir_iterative, the same augmentation rule).  None
  is "eigh" at every size on every device: the JAX package's None takes
  the iterative solve on non-CPU backends from n = 128, a TPU choice the
  port does not copy.
"""

from functools import lru_cache

import numpy as np
import torch

from ..ops.linalg import eigh_direction, newton_dir_iterative
from . import observe as _observe

_METHODS = (None, "eigh", "iterative")


def wolfe(t, grad, dp, alpha=1e-4):
    """Armijo decrease threshold alpha t <grad, dp> (reference
    newton_raphson.py:12)."""
    return alpha * t * torch.dot(grad, dp)


def newton_step_pure(gradient, hessian, mu=1e-6, rho=1.1, lambda_min=1e-6,
                     aug=True, method=None, sync_free=False):
    """dp = -H^{-1} G with conditional augmentation H += (mu+rho|l0|) I.
    Returns (dp, lowest_eigenvalue) as tensors.  ``method``: None or
    "eigh" (the exact eigendecomposition; a stack of gradients and
    Hessians gives one solve each), or "iterative" (one matrix;
    ``sync_free`` as in ``ops.linalg.newton_dir_iterative``)."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got "
                         f"{method!r}")
    if method == "iterative":
        return newton_dir_iterative(gradient, hessian, mu=mu, rho=rho,
                                    lambda_min=lambda_min, aug=aug,
                                    sync_free=sync_free)
    return eigh_direction(gradient, hessian, mu=mu, rho=rho,
                          lambda_min=lambda_min, aug=aug)


def backtracking_pure(objective_flat, params_flat, dp, gradient,
                      alpha=1e-4, beta=0.5, lmax=20, e0=None,
                      min_rel_slack=0.0):
    """Armijo backtracking on a flat parameter vector.

    objective_flat: f(flat_params) -> scalar tensor.  e0: optional
    objective at params_flat.  ``min_rel_slack``: the least slack of the
    comparison relative to max(1, |e0|) (the JAX package's 2e-6 where the
    trial energies come from float32 passes,
    auto_oo_tpu/models/oo_pqc.py:1057-1061).  Returns (new_flat_params, t,
    new_energy) with t and new_energy as Python floats."""
    if e0 is None:
        e0 = objective_flat(params_flat)
    if isinstance(e0, torch.Tensor):
        _observe.count("host_syncs")
    e0 = float(e0)
    _observe.count("host_syncs")
    gdp = float(torch.dot(gradient, dp))
    # floating-point slack on the Armijo comparison: near convergence the
    # true decrease drops below f64 resolution of the energy (~eps |e0|),
    # and a strict test would burn all lmax halvings on roundoff
    slack = (max(64.0 * np.finfo(np.float64).eps, min_rel_slack)
             * max(1.0, abs(e0)))
    t = 1.0
    for _ in range(lmax):
        e_t = objective_flat(params_flat + t * dp)
        if isinstance(e_t, torch.Tensor):
            _observe.count("host_syncs")
        e_t = float(e_t)
        if e_t <= e0 + alpha * t * gdp + slack:
            break
        t *= beta
    else:
        t, e_t = 0.0, e0
    return params_flat + t * dp, t, e_t


def armijo_steps(beta, lmax):
    """The host search's trial steps t_k: 1.0 exactly, then t_k = beta *
    t_{k-1} in float64, the same products as ``backtracking_pure``."""
    steps = [1.0]
    for _ in range(lmax - 1):
        steps.append(steps[-1] * beta)
    return steps


@lru_cache(maxsize=None)
def _steps_tensor(beta, lmax, dtype, device):
    """``armijo_steps`` on ``device``, uploaded once (an upload from the
    host's pageable memory waits for the card)."""
    return torch.tensor(armijo_steps(beta, lmax), dtype=dtype, device=device)


def armijo_select(e_trials, steps, e0, gdp, alpha, slack):
    """Per lane, the first trial that passes the Armijo test of
    ``backtracking_pure`` (e_t <= e0 + alpha t gdp + slack, the same
    float64 operations in the same order): e_trials (..., K) at the steps
    (K,), e0, gdp, slack (...).  Returns (k, ok, t, e): the index of the
    first accepted trial (an argmax over the acceptance mask), whether
    any was accepted, and t and e_t, which are 0 and e0 where none was."""
    ok_k = e_trials <= (e0[..., None] + alpha * steps * gdp[..., None]
                        + slack[..., None])
    k = torch.argmax(ok_k.to(torch.uint8), dim=-1)
    ok = ok_k.any(dim=-1)
    t = torch.where(ok, steps[k], torch.zeros_like(e0))
    e = torch.where(ok, e_trials.gather(-1, k[..., None])[..., 0], e0)
    return k, ok, t, e


def backtracking_batched(energy_fn, params_flat, dp, gradient, e0,
                         alpha=1e-4, beta=0.5, lmax=20, rounds=None):
    """Armijo backtracking of B lanes at once, decided on the device.

    params_flat, dp, gradient: (B, n); e0: (B,).  ``energy_fn(lanes,
    trials)`` gives the energies (L,) of the trial points trials (L, n) of
    the lanes ``lanes`` (an (L,) int64 device tensor), and a per-trial
    auxiliary tensor (L, ...) (the line search hands back the accepted
    one, e.g. the orbital rotation the trial energy used) or None.
    ``rounds``: the trial counts of the rounds, summing to lmax (default
    one round of lmax).  A round evaluates every lane still searching at
    its next K steps in one call; between rounds the host reads which
    lanes are still searching (one read per round, none after the last).
    The per-lane semantics are ``backtracking_pure``'s: the first trial t
    = 1.0 exactly, t times beta up to lmax trials, the slack 64 eps
    max(1, |e0|), an exhausted search t = 0 and e0.  Returns (new_flat
    (B, n), t (B,), e_t (B,), ok (B,), aux (B, ...) or None), aux
    holding zeros in the lanes where ok is False."""
    B = params_flat.shape[0]
    dev = params_flat.device
    rounds = tuple(rounds) if rounds is not None else (lmax,)
    if sum(rounds) != lmax:
        raise ValueError(f"rounds {rounds} do not sum to lmax = {lmax}")
    steps = _steps_tensor(float(beta), int(lmax), dp.dtype, dev)
    gdp = (gradient * dp).sum(-1)
    slack = 64.0 * np.finfo(np.float64).eps * torch.clamp(e0.abs(), min=1.0)
    t_sel = torch.zeros_like(e0)
    e_sel = e0.clone()
    ok_sel = torch.zeros(B, dtype=torch.bool, device=dev)
    aux_sel = None
    lanes = torch.arange(B, device=dev)
    lo = 0
    for r, K in enumerate(rounds):
        st = steps[lo:lo + K]
        L = lanes.shape[0]
        trials = (params_flat[lanes, None, :]
                  + st[None, :, None] * dp[lanes, None, :])
        e_tr, aux = energy_fn(lanes[:, None].expand(L, K).reshape(-1),
                              trials.reshape(L * K, -1))
        k, ok, t, e = armijo_select(e_tr.reshape(L, K), st, e0[lanes],
                                    gdp[lanes], alpha, slack[lanes])
        # lanes still searching at this round: nothing accepted before
        t_sel = t_sel.index_copy(0, lanes, torch.where(ok, t, t_sel[lanes]))
        e_sel = e_sel.index_copy(0, lanes, torch.where(ok, e, e_sel[lanes]))
        ok_sel = ok_sel.index_copy(0, lanes, ok)
        if aux is not None:
            aux = aux.reshape((L, K) + aux.shape[1:])
            pick = aux[torch.arange(L, device=dev), k]
            if aux_sel is None:
                aux_sel = aux.new_zeros((B,) + aux.shape[2:])
            keep = ok.reshape((L,) + (1,) * (pick.dim() - 1))
            aux_sel = aux_sel.index_copy(
                0, lanes, torch.where(keep, pick, aux_sel[lanes]))
        lo += K
        if r + 1 == len(rounds):
            break
        lanes = torch.nonzero(~ok_sel).reshape(-1)    # one host read
        if lanes.numel() == 0:
            break
    new_flat = params_flat + t_sel[:, None] * dp
    return new_flat, t_sel, e_sel, ok_sel, aux_sel


def damped_newton_step_pure(objective_flat, params_flat, gradient, hessian,
                            alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1,
                            lambda_min=1e-6, lmax=20, aug=True, e0=None,
                            min_rel_slack=0.0, method=None):
    """One damped Newton step on flat parameters; returns
    (new_flat_params, lowest_eigenvalue, t, energy_after).  ``method`` as
    in ``newton_step_pure``: the iterative solve's lowest eigenvalue is
    Rayleigh-refined, exact on separated spectra and within ~1% on
    pathologically clustered ones."""
    dp, lowest = newton_step_pure(gradient, hessian, mu=mu, rho=rho,
                                  lambda_min=lambda_min, aug=aug,
                                  method=method)
    newp, t, e_t = backtracking_pure(objective_flat, params_flat, dp,
                                     gradient, alpha=alpha, beta=beta,
                                     lmax=lmax, e0=e0,
                                     min_rel_slack=min_rel_slack)
    return newp, lowest, t, e_t


def split_list_shapes(parameters, paramshapes):
    """Split a flat vector into chunks of the given shapes
    (reference newton_raphson.py:214-224)."""
    chunks = []
    num = 0
    for shape in paramshapes:
        size = int(np.prod(shape)) if len(shape) else 1
        chunks.append(parameters[num:num + size].reshape(shape))
        num += size
    return chunks


class NewtonStep:
    """API-compatible wrapper around the pure functions
    (reference newton_raphson.py:16-211)."""

    def __init__(self, alpha=1e-4, beta=0.5, mu=1e-6, rho=1.1, lmax=20,
                 lambda_min=1e-6, aug=True, verbose=0):
        self.alpha = alpha
        self.beta = beta
        self.mu = mu
        self.rho = rho
        self.lmax = lmax
        self.lambda_min = lambda_min
        self.aug = aug
        self.verbose = verbose

    def newton_step(self, gradient, hessian):
        dp, lowest = newton_step_pure(
            gradient, hessian, mu=self.mu, rho=self.rho,
            lambda_min=self.lambda_min, aug=self.aug)
        if self.verbose:
            print("lowest eigval hessian =", float(lowest))
        return dp, float(lowest)

    def backtracking(self, objective_fn, parameters, dp, gradient):
        paramshapes = [tuple(p.shape) for p in parameters]

        def objective_flat(flat):
            return objective_fn(*split_list_shapes(flat, paramshapes))

        flat = torch.cat([p.reshape(-1) for p in parameters])
        newp, t, e_t = backtracking_pure(
            objective_flat, flat, dp, gradient,
            alpha=self.alpha, beta=self.beta, lmax=self.lmax)
        if self.verbose:
            print("line search t =", t, "new energy:", e_t)
        if len(parameters) > 1:
            return tuple(split_list_shapes(newp, paramshapes)), e_t
        return newp, e_t

    def damped_newton_step(self, objective_fn, parameters, gradient,
                           hessian):
        """Returns (new_parameters, lowest_hessian_eigenvalue) —
        reference newton_raphson.py:194-211."""
        dp, lowest = self.newton_step(gradient, hessian)
        new_parameters, _ = self.backtracking(
            objective_fn, parameters, dp, gradient)
        return new_parameters, lowest
