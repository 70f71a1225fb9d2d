"""Static FLOP count of one damped-Newton iteration, and the H100's peaks.

Port of auto_oo_tpu/utils/flops.py.  Every hot contraction of the
grad+Hessian and update programs has a shape fixed by the problem
(models/oo_pqc.py), so the algorithmic FLOPs of one NR iteration follow
from the problem's shapes alone: ncas, the state dimension D, n_theta,
n_kappa, nao, the number of occupied plus active orbitals and the number
of rotated pairs of one circuit application.  No route, kernel or
precision enters the count, so the flat, fused, staged, streamed and
hosted routes (per-tangent and Gram), f64 and mixed precision, and one
lane of a ``parallel.GeometryBatch`` get the same count for the same
problem: it is the yardstick that timings are divided by.

Counting conventions (the JAX package's, so the counts compare):

* a dot of contraction length K counts 2K FLOPs per output element
  (multiply + add);
* a pair rotation counts 8 FLOPs per rotated pair (4 mul + 2 add + 2 sign
  mul) per state application;
* a forward-mode tangent counts 2x a primal application per tangent
  (value + tangent arithmetic), a reverse-mode one ~3x;
* the counts are algorithmic FLOPs in the precision the work runs in:
  f64, or in ``precision="mixed"`` the f32 Hessian blocks beside f64
  states and orbitals.

Four terms follow the port's algorithm where the JAX package's follow
the TPU or its own:

* pairs: the real pairs of every gate.  The port pads no gate (its flat
  ``GateProgram.ia`` is a list of unpadded arrays, ``n_real_pairs`` per
  gate), and a sector circuit counts the product-grid pairs ka * kb of
  each gate of its ``GridGateProgram``, never building the flat program;
* the eigensolver: ``torch.linalg.eigh`` (cuSOLVER, dense symmetric, with
  eigenvectors) counts 9 n^3, the symmetric QR algorithm's count with
  the eigenvectors accumulated (Golub and Van Loan, Matrix Computations,
  4th ed., section 8.3.3), where the JAX package counts 30 sweeps of its
  Jacobi eigensolver (a TPU stand-in for LAPACK);
* ``newton_method=None`` counts eigh, the port's solve at every size;
  "iterative" keeps the JAX package's count;
* the transition RDMs count one gram per tangent (2 nt n2^2 D): the two
  grams of the JAX count, <dPhi|Phi> and <Phi|dPhi>, are transposes of
  each other, and the port runs one and adds its transpose
  (models/oo_pqc.py ``transition_rdms``).

The peaks are those of one NVIDIA H100 SXM5 80GB at its 700 W limit, from
NVIDIA's H100 Tensor Core GPU datasheet (dense rates, no sparsity).  A
card set below 700 W runs slower under load, so a share of these peaks
stands beside the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
On this card the f64 tensor-core peak and the f32 peak outside the tensor
cores are equal: the port turns TF32 off (config.py), so f32 GEMMs run on
the CUDA cores, and the mixed path's ceiling is the f64 path's.
"""

#: FP64 tensor-core peak, FLOP/s (H100 SXM5 80GB datasheet, 700 W)
FP64_PEAK = 67e12
#: FP32 peak without tensor cores, FLOP/s (H100 SXM5 80GB datasheet,
#: 700 W); with TF32 off it is the f32 ceiling of ``precision="mixed"``
FP32_PEAK = 67e12
#: HBM3 bandwidth, bytes/s (H100 SXM5 80GB datasheet, 700 W)
HBM_BYTES_PER_S = 3.35e12

#: the peak each ``OO_pqc(precision=)`` is measured against
PEAKS = {"f64": FP64_PEAK, "mixed": FP32_PEAK}

#: FLOPs of a dense symmetric eigendecomposition with eigenvectors, per
#: n^3 (symmetric QR, Golub and Van Loan 4th ed. section 8.3.3)
EIGH_FLOPS_PER_N3 = 9.0


def _pairs_of(pqc):
    """Rotated pairs of one application of ``pqc``'s circuit: on a sector
    the sum over its GridGateProgram's gates of ka * kb (simulator/
    grid_program.py splits each gate into its alpha and beta string
    lists; the flat program, built lazily there, is left unbuilt), else
    the real pairs of its flat GateProgram (0 for a callable ansatz)."""
    grid = getattr(pqc, "grid_program", None)
    if grid is not None:
        return int(sum(len(g.Ai_src) * len(g.Bj_src) for g in grid.gates))
    program = pqc.program
    return 0 if program is None else int(program.n_real_pairs.sum())


def grad_hess_flops(ncas, D, nt, nk, nao, ns, pairs_per_apply):
    """Algorithmic FLOPs of one grad+Hessian call (models/oo_pqc.py
    grad_hess, every route)."""
    n2 = ncas * ncas
    P = pairs_per_apply
    f = 0.0
    # psi + J (nt forward tangents, ~2x primal each)
    f += 8.0 * P * (1 + 2 * nt)
    # H-apply on psi and the nt tangent rows:
    #   Phi gathers 4 n2 D + C2 matmul 2 n2^2 D + c1 term 2 n2 D
    #   + E_pq reduction 4 n2 D
    ham = 2.0 * n2 * n2 * D + 10.0 * n2 * D
    f += ham * (1 + nt)
    # grad_c = J @ w and e0
    f += 2.0 * nt * D + 2.0 * D
    # hess_cc gram: J (nt, D) x HJ (nt, D)
    f += 2.0 * nt * nt * D
    # the circuit Hessian term d2<w, psi>: one reverse sweep carrying
    # the tangents (~3x primal per tangent)
    f += 24.0 * P * nt
    # Phi = E_pq psi (4 n2 D) and the RDM gram (2 n2^2 D)
    f += 4.0 * n2 * D + 2.0 * n2 * n2 * D
    # transition RDMs: Phi J gathers (4 n2 D nt) + one gram against Phi
    # (2 nt n2^2 D; the other is its transpose) + dgamma (4 nt n2 D)
    f += 4.0 * n2 * D * nt + 2.0 * nt * n2 * n2 * D + 4.0 * nt * n2 * D
    # AO -> MO 4-index transform (full nao, once per call)
    f += 8.0 * nao ** 5
    # analytic orbital Hessian: blocked generalized-Fock contractions,
    # O(ns^4 nao^2) leading term (ops/fock.py)
    f += 2.0 * (ns ** 4) * (nao ** 2)
    # hess_oc: the affine gradient map per tangent, O(ns^2 nao^2) each
    f += 2.0 * nt * (ns ** 2) * (nao ** 2)
    return f


def update_flops(ncas, D, nt, nk, nao, ns, pairs_per_apply,
                 newton_method=None, n_trials=1):
    """Algorithmic FLOPs of one solve + line search + MO update.

    newton_method: None or "eigh" (one dense symmetric eigendecomposition
    with eigenvectors, EIGH_FLOPS_PER_N3 n^3), or "iterative" (~300 dense
    (nt+nk)^2 matmuls: Lanczos, two Newton-Schulz inverses, refinement).
    n_trials: the Armijo trials actually run (1 where t = 1 is accepted).
    """
    if newton_method not in (None, "eigh", "iterative"):
        raise ValueError("newton_method must be None, 'eigh' or "
                         f"'iterative', got {newton_method!r}")
    n = nt + nk
    if newton_method == "iterative":
        solve = 300.0 * 2.0 * n ** 3
    else:
        solve = EIGH_FLOPS_PER_N3 * n ** 3
    n2 = ncas * ncas
    # per Armijo trial: expm (~20 nao^3 matmuls) + sub-space 4-index
    # (2 nao^4 ns + 3 smaller steps ~ 8 nao^4 ns upper envelope) + state
    # rebuild + RDM grams + energy contraction
    trial = (40.0 * nao ** 3 + 8.0 * (nao ** 4) * ns
             + 8.0 * pairs_per_apply
             + 2.0 * n2 * n2 * D + 6.0 * n2 * D)
    return solve + n_trials * trial


def _shapes(pqc, oo):
    """(ncas, D, n_theta, n_kappa, nao, ns, pairs per application) of an
    OO_pqc problem: the shapes every count reads."""
    return (pqc.ncas, int(pqc.state_dim), int(pqc.theta_shape),
            int(oo.n_kappa), int(oo.nao), len(oo._occ) + len(oo._act),
            _pairs_of(pqc))


def nr_iteration_flops(pqc, oo, n_trials=1):
    """Algorithmic FLOPs of one NR iteration of an OO_pqc problem
    (grad_hess + update), by its shapes and ``oo.newton_method``:
    {"grad_hess", "update", "total"}."""
    shapes = _shapes(pqc, oo)
    g = grad_hess_flops(*shapes)
    u = update_flops(*shapes, newton_method=oo.newton_method,
                     n_trials=n_trials)
    return {"grad_hess": g, "update": u, "total": g + u}


def armijo_trials(t, beta, lmax=20):
    """The Armijo trials a host line search ran to take step ``t``: the
    trial steps are 1, then t_k = beta t_{k-1} in float64 (utils/
    newton_raphson.py ``backtracking_pure``); t = 0 means all ``lmax``
    failed.  ``lmax`` defaults to the Newton core's (``damped_newton_
    step_pure``'s)."""
    if t == 0:
        return lmax
    step = 1.0
    for k in range(1, lmax + 1):
        if step == t:
            return k
        step *= beta
    raise ValueError(f"t = {t!r} is no Armijo step of beta = {beta!r}")


def mfu(flops_per_iter, seconds_per_iter, precision="f64"):
    """(achieved FLOP/s, fraction of the peak of ``precision``: "f64" or
    "mixed", as OO_pqc's).  The two peaks are equal on the H100."""
    achieved = flops_per_iter / seconds_per_iter
    return achieved, achieved / PEAKS[precision]
