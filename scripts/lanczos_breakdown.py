"""Lanczos breakdown on a Hessian with a null space: the JAX package's
``lanczos_lowest`` against the PyTorch port's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/lanczos_breakdown.py [trials]

The Hessian is the JAX package's grad_hess at init_zeros of the first
point of the Berry loop around the formaldimine conical intersection
((2e,2o) np_fabric L=1, freeze_active, sto-3g; n = 52 with ~9
eigenvalues at ~1e-13, so the Krylov space is invariant after ~43
steps and Lanczos breaks down).  Each trial adds a symmetric
perturbation of 1e-15 times max |H| and scales the matrix by 10^U(0, 2),
and counts the trials whose lowest Ritz value misses the lowest
eigenvalue (numpy eigvalsh) by more than 1e-6 relative to the scale.
The JAX package parks the iterations after a breakdown at +1e30 on T's
diagonal and solves the whole T (its Jacobi eigh on the CPU); the port
parks them at 1 + the live block's Gershgorin bound
(auto_oo_tpu_torch/ops/linalg.lanczos_lowest).  Prints one
JSON line.
"""

import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import auto_oo_tpu as aoo  # noqa: E402
from auto_oo_tpu.models import OO_pqc, Parameterized_circuit  # noqa: E402
from auto_oo_tpu.ops import linalg as jlinalg  # noqa: E402
from auto_oo_tpu_torch.ops import linalg  # noqa: E402


def hessian():
    geo = aoo.get_formal_geo(130 + 10 * np.cos(np.pi / 20),
                             89.9 + 10 * np.sin(np.pi / 20))
    pqc = Parameterized_circuit(2, 2, ansatz="np_fabric", n_layers=1)
    oo = OO_pqc(pqc, aoo.Moldata(geo, "sto-3g"), 2, 2, freeze_active=True)
    return np.asarray(oo.full_hessian(pqc.init_zeros()))


def main(argv):
    trials = int(argv[0]) if argv else 200
    H = hessian()
    w0 = np.linalg.eigvalsh(0.5 * (H + H.T))[0]
    jax_lanczos = jax.jit(jlinalg.lanczos_lowest)
    rng = np.random.default_rng(0)
    missed = {"jax": 0, "port": 0}
    for _ in range(trials):
        s = 10 ** rng.uniform(0, 2)
        E = rng.standard_normal(H.shape) * 1e-15 * np.abs(H).max()
        Hp = (H + 0.5 * (E + E.T)) * s
        ref = np.linalg.eigvalsh(Hp)[0] / s
        got = {"jax": float(jax_lanczos(jnp.asarray(Hp))) / s,
               "port": float(linalg.lanczos_lowest(torch.as_tensor(Hp))) / s}
        for k, v in got.items():
            missed[k] += int(abs(v - ref) > 1e-6)
    print(json.dumps({"n": int(H.shape[0]), "lowest": float(w0),
                      "trials": trials, "missed": missed}))


if __name__ == "__main__":
    main(sys.argv[1:])
