"""The Lanczos breakdown on the card: T with its dead steps parked at
+1e30 (the JAX package's form) against the port's, parked at 1 + the
live block's Gershgorin bound.

    python -m auto_oo_tpu_torch.scripts.lanczos_parking [--device cpu]

The Hessian is the port's grad_hess at init_zeros of the first point of
the Berry loop around the formaldimine conical intersection ((2e,2o)
np_fabric L=1, freeze_active, sto-3g): n = 52, nine eigenvalues at
~1e-13, so Lanczos breaks down after ~43 steps.  Prints, on the device
and on the CPU, the lowest eigenvalue of H (eigvalsh), the Lanczos
residual norms around the breakdown, the lowest eigenvalue of the parked
T by ``torch.linalg.eigvalsh`` on the device and on the CPU, and the
port's ``lanczos_lowest`` and ``newton_dir_iterative``.
"""

import argparse
import subprocess
import sys

import numpy as np
import torch

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch.ops import linalg


def parked_tridiagonal(A, k=64):
    """T of k Lanczos steps in the JAX package's form
    (auto_oo_tpu/ops/linalg.py:261-310): the steps after a breakdown keep
    +1e30 on the diagonal.  Returns (T, residual norms)."""
    n = A.shape[0]
    k = min(k, n)
    gen = torch.Generator().manual_seed(linalg._LANCZOS_SEED)
    v0 = torch.randn(n, generator=gen, dtype=A.dtype).to(A.device)
    V = A.new_zeros((k + 1, n))
    V[0] = v0 / torch.sqrt(v0 @ v0)
    alpha, beta, norms = A.new_zeros(k), A.new_zeros(k), []
    dead = torch.zeros((), dtype=torch.bool, device=A.device)
    for j in range(k):
        v = V[j]
        w = A @ v
        a = v @ w
        w = w - a * v
        if j > 0:
            w = w - beta[j - 1] * V[j - 1]
        w = w - V.T @ (V @ w)
        b = torch.sqrt(w @ w)
        norms.append(float(b))
        new_dead = dead | (b < 1e-13)
        alpha[j] = torch.where(dead, torch.full_like(a, 1e30), a)
        beta[j] = torch.where(new_dead, torch.zeros_like(b), b)
        V[j + 1] = torch.where(new_dead, torch.zeros_like(w),
                               w / torch.clamp(b, min=1e-300))
        dead = new_dead
    T = (torch.diag(alpha) + torch.diag(beta[:k - 1], 1)
         + torch.diag(beta[:k - 1], -1))
    return T, norms


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    geo = P.get_formal_geo(130 + 10 * np.cos(np.pi / 20),
                           89.9 + 10 * np.sin(np.pi / 20))
    pqc = P.Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1,
                                  device=args.device)
    oo = P.OO_pqc(pqc, P.Moldata(geo, "sto-3g"), 2, 2, freeze_active=True)
    _, g, H = oo._grad_hess(pqc.init_zeros())
    T, norms = parked_tridiagonal(H)
    dead = next(j for j, b in enumerate(norms) if b < 1e-13)
    _, low = linalg.newton_dir_iterative(g, H)
    near = ", ".join(f"{b:.1e}" for b in norms[dead - 2:dead + 1])
    print(f"device {H.device}: n = {H.shape[0]}, lowest eigenvalue of H "
          f"{float(torch.linalg.eigvalsh(H)[0]):+.15e}; breakdown at step "
          f"{dead} (residuals {near})")
    print(f"  parked T, eigvalsh on {H.device}: "
          f"{float(torch.linalg.eigvalsh(T)[0]):+.15e}; on the CPU: "
          f"{float(torch.linalg.eigvalsh(T.cpu())[0]):+.15e}")
    print(f"  lanczos_lowest (dead steps parked at the Gershgorin bound): "
          f"{float(linalg.lanczos_lowest(H)):+.15e}; newton_dir_iterative "
          f"lowest {float(low):+.15e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
