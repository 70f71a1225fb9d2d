"""Adam, in optax's order of operations.

The JAX package's ``OO_pqc.gradient_optimization`` takes any optax
``GradientTransformation`` and defaults to ``optax.adam``.  This module
gives the same protocol on tensors: ``adam(...)`` returns an object with
``init(params) -> state`` and ``update(grad, state, params) -> (updates,
state)``, and ``apply_updates(params, updates)`` adds them.

The arithmetic is optax 0.2.6's ``scale_by_adam`` then
``scale_by_learning_rate``, operation for operation:

    mu = (1 - b1) g + b1 mu            nu = (1 - b2) g^2 + b2 nu
    count += 1 (int32, saturating)
    mu_hat = mu / (1 - b1^count)       nu_hat = nu / (1 - b2^count)
    updates = (-lr) * (mu_hat / (sqrt(nu_hat + eps_root) + eps))

with b^count from the C library's pow, as optax's jitted bias correction
takes it on the CPU, every division by a full tensor and the square root
correctly rounded, so the same gradients give the same bits.
``torch.optim.Adam`` folds the corrections into the step size and the
denominator instead; near ``eps`` the ratio g / (|g| + eps) turns that
different rounding into visible changes of theta.
"""

from typing import NamedTuple

import numpy as np
import torch

_INT32_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor     # int32 scalar on the host
    mu: torch.Tensor
    nu: torch.Tensor


class GradientTransformation(NamedTuple):
    init: object
    update: object


def _sqrt(x):
    """The correctly rounded square root, as XLA's: the card's float64
    sqrt is; PyTorch's vectorized CPU kernel misrounds some float64
    inputs by one ulp, so a CPU tensor takes numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """optax.adam(learning_rate, b1, b2, eps, eps_root) on one tensor of
    parameters; the moments live on the parameters' device and dtype."""
    step_size = -1 * learning_rate

    def init(params):
        return AdamState(count=torch.zeros((), dtype=torch.int32),
                         mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params))

    def update(grad, state, params=None):
        del params
        mu = (1 - b1) * grad + b1 * state.mu
        nu = (1 - b2) * grad ** 2 + b2 * state.nu
        n = min(int(state.count) + 1, _INT32_MAX)
        # divided by full tensors: PyTorch multiplies by the reciprocal
        # of a scalar divisor, which rounds twice
        mu_hat = mu / torch.full_like(mu, 1 - b1 ** n)
        nu_hat = nu / torch.full_like(nu, 1 - b2 ** n)
        updates = step_size * (mu_hat / (_sqrt(nu_hat + eps_root) + eps))
        count = torch.tensor(n, dtype=torch.int32)
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates in the parameters' dtype (optax.apply_updates)."""
    return (params + updates).to(params.dtype)
