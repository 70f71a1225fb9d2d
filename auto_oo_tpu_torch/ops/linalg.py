"""Dense linear algebra of the optimizer: the matrix exponential of the
orbital rotation, the symmetric eigendecomposition of the Newton step and
the iterative damped-Newton direction.

Port of auto_oo_tpu/ops/linalg.py without its TPU workarounds (scalar f64
trig guards, the Taylor expm, the Jacobi eigh): on the card and the CPU
alike, PyTorch's own routines are exact in float64 (``expm`` takes
``matrix_exp``'s stacked path, see there).  ``eigh``
symmetrizes its input, as the JAX package's CPU eigh
(``jnp.linalg.eigh``, ``symmetrize_input=True``) does, where
``torch.linalg.eigh`` alone would read only the lower triangle.

``eigh`` and ``eigh_direction`` take a stack of matrices (one per
geometry of a batch) as well as one.

``newton_dir_iterative`` is the JAX package's eigh-free Newton direction
(Lanczos, Newton-Schulz inverse, inverse-Lanczos refinement) with its
descent/residual guard; the guard's ``lax.cond`` is a host branch on one
scalar here, and ``ITERATIVE_FALLBACKS`` counts the solves that fell back
to eigh.  With ``sync_free=True`` (the device loop of
``OO_pqc.full_optimization``) the port's own code reads nothing on the
host: the guard selects between the iterative and the eigh direction on
the device, so eigh runs every time (those fallbacks are not counted)
and the solve costs more than eigh alone.

``gram_last`` is the contraction over a state axis that the mixed
precision mode (``OO_pqc(precision="mixed")``) runs in float32.
"""

from functools import lru_cache

import torch

# terms of one float32 sum over a state axis: the card's GEMMs add a
# thread's terms in one chain, whose rounding grows like eps * sqrt(terms)
# (1e-4 relative at 10^7 terms, the length of one (16e,16o) chunk), so
# longer sums are cut into pieces whose float32 sums are added in float64
_F32_TERMS = 1 << 12

# float32 elements of the pieces' partial sums held at once
_F32_PARTIALS = 1 << 24


def expm(A):
    """Matrix exponential of one matrix or a stack (..., n, n).

    ``torch.linalg.matrix_exp`` picks a Taylor degree from the norm of a
    single matrix, and that path was off by 1.8e-11 (orthogonality
    6e-13) for a skew matrix of 1-norm 0.034, a first-iteration orbital
    rotation of the (10e,10o) slice, on an H100 and on the CPU alike;
    a stack takes its degree-18 scaling-and-squaring path, within 4e-16
    of scipy's expm there.  So one matrix goes through it as a stack of
    two, and a lane of a batch gets the same bits as a sequential call."""
    if A.dim() == 2:
        return torch.linalg.matrix_exp(A.expand((2,) + tuple(A.shape)))[0]
    return torch.linalg.matrix_exp(A)


def eigh(A):
    """(eigenvalues ascending, eigenvectors) of (A + A^T) / 2, for one
    matrix or a stack (..., n, n): a symmetric A unchanged to the bit, a
    non-symmetric one (the noisy Hessian's cc block) solved as the JAX
    package's eigh solves it."""
    return torch.linalg.eigh(0.5 * (A + A.mT))


# the seed of the Lanczos start vector; the JAX package draws its start
# from jax.random.PRNGKey(7), a stream the port cannot reproduce without
# JAX, so the port draws a normal vector from a torch.Generator seeded
# with the same number (on the CPU, so every device gets the same vector)
_LANCZOS_SEED = 7

_NS_ITERS = 100

# solves of newton_dir_iterative whose guard fell back to eigh
ITERATIVE_FALLBACKS = 0


@lru_cache(maxsize=None)
def _lanczos_start(n, dtype, device):
    """The Lanczos start vector of size n, drawn on the CPU and uploaded
    once per (n, dtype, device)."""
    gen = torch.Generator().manual_seed(_LANCZOS_SEED)
    return torch.randn(n, generator=gen, dtype=dtype).to(device)


def lanczos_lowest(A, k=64):
    """Lowest eigenvalue of symmetric A by k-step Lanczos with full
    reorthogonalization, from a seeded pseudo-random start (a structured
    start can be near-orthogonal to the extremal eigenvector).  Nothing
    is read on the host.

    The start differs from the JAX package's draw (see ``_LANCZOS_SEED``):
    for n <= k the Krylov space is the whole space and both agree to
    rounding; above that both converge the extremal Ritz value to ~1e-10
    on a separated spectrum.  On breakdown (a new Lanczos vector of norm
    below 1e-13, as in the JAX package: the Krylov space is invariant) the
    steps after it are dead: T keeps all k steps, the dead steps'
    diagonal parked at 1 + the live block's Gershgorin bound (their
    off-diagonals are exact zeros), so T is the live block beside a
    diagonal above its spectrum, of no larger magnitude.  The JAX package
    parks that diagonal at +1e30 instead, whose mixed magnitudes an
    eigensolver need not resolve: on an H100 that returned a Ritz value
    far below the spectrum (ROADMAP queue 3)."""
    n = A.shape[0]
    k = min(k, n)
    v0 = _lanczos_start(n, A.dtype, A.device)
    V = A.new_zeros((k + 1, n))
    V[0] = v0 / torch.sqrt(v0 @ v0)
    alpha = A.new_zeros(k)
    beta = A.new_zeros(k)
    dead = torch.zeros((), dtype=torch.bool, device=A.device)
    live = torch.zeros((), dtype=torch.int64, device=A.device)
    for j in range(k):
        v = V[j]
        w = A @ v
        a = v @ w
        w = w - a * v
        if j > 0:
            w = w - beta[j - 1] * V[j - 1]
        # full reorthogonalization (rows > j are zero)
        w = w - V.T @ (V @ w)
        b = torch.sqrt(w @ w)
        live = live + (~dead).long()
        dead = dead | (b < 1e-13)
        alpha[j] = a
        beta[j] = torch.where(dead, torch.zeros_like(b), b)
        V[j + 1] = torch.where(dead, torch.zeros_like(w),
                               w / torch.clamp(b, min=1e-300))
    off = beta[:k - 1].abs()
    bound = 1.0 + (alpha.abs() + torch.cat([off, off.new_zeros(1)])
                   + torch.cat([off.new_zeros(1), off])).max()
    steps = torch.arange(k, device=A.device)
    diag = torch.where(steps < live, alpha, bound)
    T = (torch.diag(diag) + torch.diag(beta[:k - 1], 1)
         + torch.diag(beta[:k - 1], -1))
    return torch.linalg.eigvalsh(T)[0]


def symmetric_inverse_ns(A, iters=_NS_ITERS, with_residual=False):
    """Inverse of a nonsingular symmetric A by Newton-Schulz iteration
    from X0 = A / r^2 (r the largest row 1-norm): X0 A = A^2 / r^2 is
    positive semidefinite with spectrum in (0, 1], so the error squares
    each step for any symmetric nonsingular A, indefinite included.
    ``with_residual=True`` also returns ||I - X A||_F / sqrt(n), which
    exposes an unconverged inverse (cond(A) beyond ~2^(iters/2 - 3))."""
    n = A.shape[0]
    r = A.abs().sum(dim=1).max()
    X = A / (r * r)
    eye2 = 2.0 * torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        X = X @ (eye2 - A @ X)
    if not with_residual:
        return X
    R = 0.5 * eye2 - X @ A
    return X, torch.sqrt((R * R).sum() / n)


def _power_max(X, iters=24):
    """Largest eigenvalue of a positive-definite X by power iteration from
    the uniform start."""
    n = X.shape[0]
    v = X.new_full((n,), 1.0 / float(n) ** 0.5)
    for _ in range(iters):
        w = X @ v
        v = w / torch.sqrt(w @ w)
    return v @ (X @ v)


def eigh_direction(gradient, H, mu=1e-6, rho=1.1, lambda_min=1e-6,
                   aug=True):
    """(dp, lowest) of the exact eigh solve, dp = -H^{-1} g with the
    canonical augmentation H += (mu + rho |l0|) I where the lowest
    eigenvalue l0 < lambda_min.  A stack of gradients (..., n) and
    Hessians (..., n, n) gives one direction and eigenvalue per matrix.
    The direction -V diag(1 / (w + shift)) V^T g does not depend on the
    signs (or, within a degenerate eigenspace, the basis) that the solver
    picks for the eigenvectors."""
    w, V = eigh(H)
    lowest = w[..., 0]
    shift = (torch.where(lowest < lambda_min, mu + rho * lowest.abs(),
                         torch.zeros_like(lowest))
             if aug else torch.zeros_like(lowest))
    if gradient.dim() > 1:
        coef = (V.mT @ gradient[..., None])[..., 0] / (w + shift[..., None])
        return -(V @ coef[..., None])[..., 0], lowest
    return -(V @ ((V.T @ gradient) / (w + shift))), lowest


def newton_dir_iterative(gradient, hessian, mu=1e-6, rho=1.1,
                         lambda_min=1e-6, aug=True, lanczos_k=64,
                         ns_iters=_NS_ITERS, sync_free=False):
    """Damped-Newton direction without an eigendecomposition (the JAX
    package's ``newton_dir_iterative``): (A) a coarse lowest eigenvalue by
    Lanczos sets a probe shift below the spectrum; (B) Lanczos on the
    Newton-Schulz inverse of the shifted H refines the lowest eigenvalue
    (inversion separates a clustered small end); (C) the canonical
    augmentation at that eigenvalue, one more Newton-Schulz inverse and
    one step of iterative refinement.  Returns (dp, lowest).

    Guard: if the relative residual ||Haug dp + g|| exceeds 1e-6 ||g||
    or g.dp is not a descent (up to 1e-12 |g| |dp|), the direction and
    eigenvalue come from the exact eigh solve instead (one host sync per
    call decides; ``ITERATIVE_FALLBACKS`` counts the fallbacks).  With
    ``sync_free=True`` nothing is read on the host: the guard is a
    ``torch.where`` over both directions, so the eigh solve runs on every
    call (the cost of a device-side choice without a device-side branch)
    and its uses are not counted."""
    global ITERATIVE_FALLBACKS
    H = hessian
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    # A: the 2x margin puts -sigma_probe below the whole spectrum even if
    # the coarse estimate undershoots |lambda_min| by up to ~3x
    lam_c = lanczos_lowest(H, k=lanczos_k)
    sigma_probe = mu + 2.0 * rho * torch.clamp(lam_c, max=0.0).abs()
    Xp = symmetric_inverse_ns(H + sigma_probe * eye, iters=ns_iters)
    # B: lambda_0 = 1 / lambda_max((H + sigma)^-1) - sigma
    refined = 1.0 / (-lanczos_lowest(-Xp, k=min(48, n))) - sigma_probe
    lowest = torch.minimum(refined, lam_c)
    shift = (torch.where(lowest < lambda_min, mu + rho * lowest.abs(),
                         torch.zeros_like(lowest))
             if aug else torch.zeros_like(lowest))
    # C: the final solve at the canonical shift
    Haug = H + shift * eye
    X = symmetric_inverse_ns(Haug, iters=ns_iters)
    dp = -(X @ gradient)
    dp = dp + X @ (-gradient - Haug @ dp)
    gnorm = torch.sqrt(gradient @ gradient)
    dpnorm = torch.sqrt(dp @ dp)
    rnorm = torch.sqrt(((Haug @ dp + gradient) ** 2).sum())
    ok = ((rnorm <= 1e-6 * gnorm + 1e-300)
          & ((gradient @ dp) <= 1e-12 * gnorm * dpnorm))
    if sync_free:
        dp_e, low_e = eigh_direction(gradient, H, mu, rho, lambda_min, aug)
        return torch.where(ok, dp, dp_e), torch.where(ok, lowest, low_e)
    if bool(ok):
        return dp, lowest
    ITERATIVE_FALLBACKS += 1
    return eigh_direction(gradient, H, mu, rho, lambda_min, aug)


def gram_last(A, B):
    """A @ B^T, or A @ B for a vector B, over the last axis (the state
    axis): A (..., M, K), B (N, K) or (K,), no conjugation (the caller
    conjugates the bra side, as the JAX package's ``gram_last(conj(a),
    b)`` calls do).  Float64 and complex128 operands take one matmul.
    Float32 and complex64 ones are multiplied in their own precision over
    pieces of at least ``_F32_TERMS`` terms (more where the M x N partial
    sums of all pieces would pass ``_F32_PARTIALS`` elements), and the
    pieces' sums are added in float64 (complex128): the result is
    float64 (complex128), the products and the sums inside a piece
    single precision."""
    vec = B.dim() == 1
    if A.dtype in (torch.float64, torch.complex128):
        return A @ (B if vec else B.T)
    acc = torch.complex128 if A.is_complex() else torch.float64
    Bm = B[None] if vec else B
    K = A.shape[-1]
    A2 = A.reshape(-1, K)
    M, N = A2.shape[0], Bm.shape[0]
    piece = max(_F32_TERMS, -(-K // max(1, _F32_PARTIALS // (M * N))))
    m = K // piece
    out = A2.new_zeros((M, N), dtype=acc)
    if m:
        Ap = A2[:, :m * piece].reshape(M, m, piece).transpose(0, 1)
        Bp = Bm[:, :m * piece].reshape(N, m, piece).permute(1, 2, 0)
        out += torch.bmm(Ap, Bp).sum(0, dtype=acc)
    if m * piece < K:
        out += A2[:, m * piece:] @ Bm[:, m * piece:].T
    out = out.reshape(A.shape[:-1] + (N,))
    return out[..., 0] if vec else out
