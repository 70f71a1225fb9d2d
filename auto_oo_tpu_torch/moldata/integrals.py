"""McMurchie-Davidson Gaussian integral engine (host side, numpy).

Computes overlap, kinetic, nuclear-attraction and two-electron repulsion
integrals over contracted spherical Gaussian AOs.  This replaces the libcint
(C) capability the reference consumed through PySCF
(reference moldata_pyscf.py:30-32):

* ``int1e_kin + int1e_nuc``  -> :func:`kinetic` + :func:`nuclear_attraction`
* ``int2e`` (chemist (pq|rs)) -> :func:`eri`
* ``int1e_ovlp``              -> :func:`overlap`

Design notes: integrals are evaluated per shell pair/quartet with full numpy
vectorization over primitive combinations via Hermite expansion (E) tables
and Hermite-Coulomb (R) tables; cartesian results are transformed to real
spherical harmonics and every contracted AO is renormalized to unit
self-overlap.  A C++ kernel (native/eri.cpp) can replace the ERI inner
loop; this module is the always-available reference implementation.
"""

import numpy as np
from scipy.special import hyp1f1

# ---------------------------------------------------------------------------
# cartesian monomial ordering (matches the common xx, xy, xz, yy, ... order)
# ---------------------------------------------------------------------------


def cart_components(l):
    """Cartesian (lx,ly,lz) components of shell l in canonical order."""
    out = []
    for lx in range(l, -1, -1):
        for ly in range(l - lx, -1, -1):
            out.append((lx, ly, l - lx - ly))
    return out


def _dfact(n):
    """(2n-1)!! with (−1)!! = 1."""
    out = 1
    for k in range(2 * n - 1, 0, -2):
        out *= k
    return out


def primitive_norm(l, alpha):
    """Norm of the (l,0,0) cartesian primitive x^l exp(-alpha r^2)."""
    return ((2 * alpha / np.pi) ** 0.75
            * (4 * alpha) ** (l / 2.0) / np.sqrt(_dfact(l)))


# ---------------------------------------------------------------------------
# cartesian -> real spherical harmonic transformation
# ---------------------------------------------------------------------------

_C2S_CACHE = {}


def cart2sph_matrix(l):
    """(ncart, nsph) transformation from cartesian monomials to real solid
    harmonics.  Components are ordered m = -l..l except l=1 which uses the
    (x, y, z) ordering so that p-shell golden arrays carry over.

    Built numerically: r^l Y_lm is a homogeneous polynomial of degree l, so
    its monomial coefficients are recovered exactly by least squares on
    sample directions; columns are scaled so all components share the norm
    of the pure (x^l-type) component (final AO renormalization makes each
    contracted AO unit-norm downstream).
    """
    if l in _C2S_CACHE:
        return _C2S_CACHE[l]
    cart = cart_components(l)
    if l == 0:
        mat = np.ones((1, 1))
    elif l == 1:
        mat = np.eye(3)  # x, y, z
    else:
        rng = np.random.RandomState(7)
        pts = rng.randn(4 * len(cart) + 16, 3)
        pts /= np.linalg.norm(pts, axis=1)[:, None]
        x, y, z = pts.T
        phi = np.arctan2(y, x)
        theta = np.arccos(z)
        A = np.stack([x ** lx * y ** ly * z ** lz for lx, ly, lz in cart],
                     axis=1)
        cols = []
        from scipy.special import sph_harm_y
        for m in range(-l, l + 1):
            am = abs(m)
            ylm = sph_harm_y(l, am, theta, phi)
            if m < 0:
                vals = np.sqrt(2.0) * (-1) ** m * ylm.imag
            elif m == 0:
                vals = ylm.real
            else:
                vals = np.sqrt(2.0) * (-1) ** m * ylm.real
            coef, *_ = np.linalg.lstsq(A, vals, rcond=None)
            coef[np.abs(coef) < 1e-10] = 0.0
            cols.append(coef)
        mat = np.stack(cols, axis=1)
        # scale columns so every sph component has the same self-overlap as
        # the pure x^l cartesian component, keeping the dominant sign
        # positive (matches the common dz2-positive style conventions).
        ncart_n = len(cart)
        metric = np.zeros((ncart_n, ncart_n))
        for i, (lx, ly, lz) in enumerate(cart):
            for j, (mx, my, mz) in enumerate(cart):
                tx, ty, tz = lx + mx, ly + my, lz + mz
                if tx % 2 or ty % 2 or tz % 2:
                    continue
                metric[i, j] = (_dfact(tx // 2) * _dfact(ty // 2)
                                * _dfact(tz // 2))
        ref = _dfact(l)  # norm^2 of the x^l component in the same metric
        for c in range(mat.shape[1]):
            col = mat[:, c]
            nrm2 = col @ metric @ col
            col = col * np.sqrt(ref / nrm2)
            if col[np.argmax(np.abs(col))] < 0:
                col = -col
            mat[:, c] = col
    _C2S_CACHE[l] = mat
    return mat


# ---------------------------------------------------------------------------
# Hermite expansion coefficients
# ---------------------------------------------------------------------------


def _e_tables(la, lb, a, b, AB):
    """E_t^{ij} tables for one shell pair, one dimension at a time.

    Returns E[d][i][j] = ndarray (K,) for t in 0..i+j stacked as (K, i+j+1),
    for i <= la, j <= lb, where K = len(a)*len(b) primitive combinations.
    """
    K = a.size * b.size
    aa = np.repeat(a, b.size)
    bb = np.tile(b, a.size)
    p = aa + bb
    mu = aa * bb / p
    tables = []
    for d in range(3):
        Q = AB[d]
        Xpa = -bb * Q / p
        Xpb = aa * Q / p
        E = {}
        E[(0, 0)] = np.exp(-mu * Q * Q)[:, None]  # (K, 1)
        for i in range(la + 1):
            for j in range(lb + 1):
                if (i, j) == (0, 0):
                    continue
                if j == 0:
                    src = E[(i - 1, 0)]
                    X = Xpa
                else:
                    src = E[(i, j - 1)]
                    X = Xpb
                nt = src.shape[1] + 1
                new = np.zeros((K, nt))
                # E_t = (1/2p) E'_{t-1} + Xp E'_t + (t+1) E'_{t+1}
                new[:, 1:] += src / (2 * p)[:, None]
                new[:, :-1] += X[:, None] * src
                tcoef = np.arange(1, src.shape[1])
                new[:, :-2] += tcoef[None, :] * src[:, 1:]
                E[(i, j)] = new
        tables.append(E)
    return tables, p, aa, bb


def _pair_hermite(sha, shb, extra=0):
    """Full 3D Hermite expansion for a shell pair.

    Returns (theta, p, P, cpair) where
      theta: (ncart_a*ncart_b, K, (L+1)^3) with L = la+lb(+extra unused),
      p: (K,), P: (K,3), cpair: (K,) contraction coefs incl. primitive norms.
    """
    la, lb = sha.l, shb.l
    A, B = sha.center, shb.center
    tabs, p, aa, bb = _e_tables(la, lb, sha.exps, shb.exps, A - B)
    P = (aa[:, None] * A[None, :] + bb[:, None] * B[None, :]) / p[:, None]
    ca = sha.coefs * np.array([primitive_norm(la, al) for al in sha.exps])
    cb = shb.coefs * np.array([primitive_norm(lb, al) for al in shb.exps])
    cpair = np.repeat(ca, cb.size) * np.tile(cb, ca.size)
    L = la + lb
    carts_a = cart_components(la)
    carts_b = cart_components(lb)
    K = p.size
    n1 = L + 1
    theta = np.zeros((len(carts_a) * len(carts_b), K, n1 * n1 * n1))
    for ia, (ax, ay, az) in enumerate(carts_a):
        for ib, (bx, by, bz) in enumerate(carts_b):
            Ex = tabs[0][(ax, bx)]
            Ey = tabs[1][(ay, by)]
            Ez = tabs[2][(az, bz)]
            ntx, nty, ntz = Ex.shape[1], Ey.shape[1], Ez.shape[1]
            blk = (Ex[:, :, None, None] * Ey[:, None, :, None]
                   * Ez[:, None, None, :])
            full = np.zeros((K, n1, n1, n1))
            full[:, :ntx, :nty, :ntz] = blk
            theta[ia * len(carts_b) + ib] = full.reshape(K, -1)
    return theta, p, P, cpair


# ---------------------------------------------------------------------------
# Boys function and Hermite-Coulomb R tensor
# ---------------------------------------------------------------------------


def boys(n_max, x):
    """F_n(x) for n = 0..n_max; x is an array. Returns (n_max+1, *x.shape)."""
    x = np.asarray(x, dtype=float)
    out = np.empty((n_max + 1,) + x.shape)
    for n in range(n_max + 1):
        out[n] = hyp1f1(n + 0.5, n + 1.5, -x) / (2 * n + 1)
    return out


def _r_tensor(Lmax, alpha, PQ):
    """Hermite-Coulomb integrals R_{tuv}(alpha, PQ) for t+u+v <= Lmax.

    alpha: (K,), PQ: (K,3).  Returns (K, Lmax+1, Lmax+1, Lmax+1).
    """
    K = alpha.size
    r2 = np.einsum("kd,kd->k", PQ, PQ)
    F = boys(Lmax, alpha * r2)  # (Lmax+1, K)
    pref = (-2.0 * alpha[None, :]) ** np.arange(Lmax + 1)[:, None]
    base = pref * F  # R^n_000
    n1 = Lmax + 1
    # R[n][t,u,v] built by downward recursion in n
    R_prev = {(0, 0, 0): base[Lmax]}
    for n in range(Lmax - 1, -1, -1):
        R_cur = {(0, 0, 0): base[n]}
        for t in range(Lmax - n + 1):
            for u in range(Lmax - n - t + 1):
                for v in range(Lmax - n - t - u + 1):
                    if t + u + v == 0:
                        continue
                    if t > 0:
                        val = PQ[:, 0] * R_prev[(t - 1, u, v)]
                        if t > 1:
                            val = val + (t - 1) * R_prev[(t - 2, u, v)]
                    elif u > 0:
                        val = PQ[:, 1] * R_prev[(t, u - 1, v)]
                        if u > 1:
                            val = val + (u - 1) * R_prev[(t, u - 2, v)]
                    else:
                        val = PQ[:, 2] * R_prev[(t, u, v - 1)]
                        if v > 1:
                            val = val + (v - 1) * R_prev[(t, u, v - 2)]
                    R_cur[(t, u, v)] = val
        R_prev = R_cur
    R = np.zeros((K, n1, n1, n1))
    for (t, u, v), val in R_prev.items():
        R[:, t, u, v] = val
    return R


# ---------------------------------------------------------------------------
# one-electron integrals
# ---------------------------------------------------------------------------


def _overlap_kinetic_block(sha, shb):
    """Cartesian overlap and kinetic blocks for a shell pair."""
    la, lb = sha.l, shb.l
    A, B = sha.center, shb.center
    # E tables up to lb+2 for the kinetic operator acting on ket
    tabs, p, aa, bb = _e_tables(la, lb + 2, sha.exps, shb.exps, A - B)
    ca = sha.coefs * np.array([primitive_norm(la, al) for al in sha.exps])
    cb = shb.coefs * np.array([primitive_norm(lb, al) for al in shb.exps])
    cpair = np.repeat(ca, cb.size) * np.tile(cb, ca.size)
    pref = cpair * (np.pi / p) ** 1.5

    def S1(d, i, j):
        if j < 0:
            return np.zeros_like(p)
        return tabs[d][(i, j)][:, 0]

    carts_a = cart_components(la)
    carts_b = cart_components(lb)
    S = np.zeros((len(carts_a), len(carts_b)))
    T = np.zeros((len(carts_a), len(carts_b)))
    for ia, ca_ in enumerate(carts_a):
        for ib, cb_ in enumerate(carts_b):
            s_d = [S1(d, ca_[d], cb_[d]) for d in range(3)]
            S[ia, ib] = np.sum(pref * s_d[0] * s_d[1] * s_d[2])
            t_d = []
            for d in range(3):
                j = cb_[d]
                term = (-2.0 * bb ** 2 * S1(d, ca_[d], j + 2)
                        + bb * (2 * j + 1) * s_d[d])
                if j >= 2:
                    term = term - 0.5 * j * (j - 1) * S1(d, ca_[d], j - 2)
                t_d.append(term)
            tk = (t_d[0] * s_d[1] * s_d[2] + s_d[0] * t_d[1] * s_d[2]
                  + s_d[0] * s_d[1] * t_d[2])
            T[ia, ib] = np.sum(pref * tk)
    return S, T


def _nuclear_block(sha, shb, charges, coords):
    """Cartesian nuclear-attraction block for a shell pair."""
    theta, p, P, cpair = _pair_hermite(sha, shb)
    L = sha.l + shb.l
    n1 = L + 1
    V = np.zeros(theta.shape[0])
    acc = np.zeros((p.size, n1 ** 3))
    for Z, C in zip(charges, coords):
        R = _r_tensor(L, p, P - C[None, :])
        acc += -Z * R.reshape(p.size, -1)
    w = cpair * (2 * np.pi / p)
    V = np.einsum("ckh,k,kh->c", theta, w, acc)
    ncb = len(cart_components(shb.l))
    return V.reshape(-1, ncb)


def _basis_layout(shells, spherical=True):
    offs_cart, offs_sph = [], []
    oc = osph = 0
    for sh in shells:
        offs_cart.append(oc)
        offs_sph.append(osph)
        oc += sh.ncart
        osph += sh.nsph if spherical else sh.ncart
    return offs_cart, oc, offs_sph, osph


def _c2s_blockdiag(shells):
    offs_cart, ncart, offs_sph, nsph = _basis_layout(shells)
    M = np.zeros((ncart, nsph))
    for sh, oc, os_ in zip(shells, offs_cart, offs_sph):
        M[oc:oc + sh.ncart, os_:os_ + sh.nsph] = cart2sph_matrix(sh.l)
    return M


def one_electron_integrals(shells, charges, coords):
    """Returns (S, T, V) in the normalized spherical AO basis, plus the
    per-AO normalization vector (applied)."""
    offs_cart, ncart, _, _ = _basis_layout(shells)
    S = np.zeros((ncart, ncart))
    T = np.zeros((ncart, ncart))
    V = np.zeros((ncart, ncart))
    for i, sha in enumerate(shells):
        oa = offs_cart[i]
        for j, shb in enumerate(shells):
            if j > i:
                continue
            ob = offs_cart[j]
            sb, tb = _overlap_kinetic_block(sha, shb)
            vb = _nuclear_block(sha, shb, charges, coords)
            S[oa:oa + sha.ncart, ob:ob + shb.ncart] = sb
            T[oa:oa + sha.ncart, ob:ob + shb.ncart] = tb
            V[oa:oa + sha.ncart, ob:ob + shb.ncart] = vb
            if i != j:
                S[ob:ob + shb.ncart, oa:oa + sha.ncart] = sb.T
                T[ob:ob + shb.ncart, oa:oa + sha.ncart] = tb.T
                V[ob:ob + shb.ncart, oa:oa + sha.ncart] = vb.T
    C = _c2s_blockdiag(shells)
    S = C.T @ S @ C
    T = C.T @ T @ C
    V = C.T @ V @ C
    norms = 1.0 / np.sqrt(np.diag(S))
    S = S * norms[:, None] * norms[None, :]
    T = T * norms[:, None] * norms[None, :]
    V = V * norms[:, None] * norms[None, :]
    return S, T, V, norms


# ---------------------------------------------------------------------------
# two-electron integrals
# ---------------------------------------------------------------------------


def eri(shells, norms=None):
    """Full (pq|rs) chemist-ordered ERI tensor in the normalized spherical
    AO basis.  Uses the native C++ engine when available (built on first
    use, native/eri.cpp), else the vectorized numpy path; both share
    the cart->sph and normalization stage."""
    from .. import native as _native
    G = _native.eri_cart(shells)
    if G is None:
        G = _eri_cart_numpy(shells)
    C = _c2s_blockdiag(shells)
    G = np.einsum("pi,pqrs->iqrs", C, G, optimize=True)
    G = np.einsum("qj,iqrs->ijrs", C, G, optimize=True)
    G = np.einsum("rk,ijrs->ijks", C, G, optimize=True)
    G = np.einsum("sl,ijks->ijkl", C, G, optimize=True)
    if norms is not None:
        G = np.einsum("i,j,k,l,ijkl->ijkl", norms, norms, norms, norms, G,
                      optimize=True)
    return G


def _eri_cart_numpy(shells):
    """Cartesian (ab|cd) tensor via the numpy engine (8-fold shell-quartet
    symmetry)."""
    nsh = len(shells)
    offs_cart, ncart, _, _ = _basis_layout(shells)
    # precompute pair data
    pair = {}
    for i in range(nsh):
        for j in range(i + 1):
            theta, p, P, cpair = _pair_hermite(shells[i], shells[j])
            pair[(i, j)] = (theta * cpair[None, :, None], p, P,
                            shells[i].l + shells[j].l)
    G = np.zeros((ncart, ncart, ncart, ncart))
    sign_cache = {}
    for i in range(nsh):
        for j in range(i + 1):
            tab, pab, Pab, Lab = pair[(i, j)]
            ij = i * (i + 1) // 2 + j
            for k in range(nsh):
                for l_ in range(k + 1):
                    kl = k * (k + 1) // 2 + l_
                    if kl > ij:
                        continue
                    tcd, pcd, Pcd, Lcd = pair[(k, l_)]
                    Ltot = Lab + Lcd
                    Kab, Kcd = pab.size, pcd.size
                    alpha = (pab[:, None] * pcd[None, :]
                             / (pab[:, None] + pcd[None, :])).ravel()
                    PQ = (Pab[:, None, :] - Pcd[None, :, :]).reshape(-1, 3)
                    R = _r_tensor(Ltot, alpha, PQ).reshape(
                        Kab, Kcd, Ltot + 1, Ltot + 1, Ltot + 1)
                    pref = (2 * np.pi ** 2.5
                            / (pab[:, None] * pcd[None, :]
                               * np.sqrt(pab[:, None] + pcd[None, :])))
                    n1a, n1c = Lab + 1, Lcd + 1
                    key = (Lab, Lcd)
                    if key not in sign_cache:
                        # gather map R2[h1, h2] = R[t+tau, u+nu, v+phi],
                        # ket side carries (-1)^{tau+nu+phi}
                        ta = np.stack(np.unravel_index(
                            np.arange(n1a ** 3), (n1a, n1a, n1a)), axis=1)
                        tc = np.stack(np.unravel_index(
                            np.arange(n1c ** 3), (n1c, n1c, n1c)), axis=1)
                        idx = ta[:, None, :] + tc[None, :, :]
                        sgn = (-1.0) ** tc.sum(axis=1)
                        sign_cache[key] = (idx, sgn)
                    idx, sgn = sign_cache[key]
                    R2 = R[:, :, idx[..., 0], idx[..., 1], idx[..., 2]]
                    R2 = R2 * (pref[:, :, None, None] * sgn[None, None,
                                                            None, :])
                    blk = np.einsum("akh,bli,klhi->ab", tab, tcd, R2,
                                    optimize=True)
                    na, nb = shells[i].ncart, shells[j].ncart
                    nc, nd = shells[k].ncart, shells[l_].ncart
                    blk = blk.reshape(na, nb, nc, nd)
                    oa, ob = offs_cart[i], offs_cart[j]
                    oc, od = offs_cart[k], offs_cart[l_]
                    _fill_eri(G, blk, oa, ob, oc, od, na, nb, nc, nd)
    return G


def _fill_eri(G, blk, oa, ob, oc, od, na, nb, nc, nd):
    """Scatter one shell-quartet block into all 8 symmetric positions."""
    sl = (slice(oa, oa + na), slice(ob, ob + nb),
          slice(oc, oc + nc), slice(od, od + nd))
    G[sl[0], sl[1], sl[2], sl[3]] = blk
    G[sl[1], sl[0], sl[2], sl[3]] = blk.transpose(1, 0, 2, 3)
    G[sl[0], sl[1], sl[3], sl[2]] = blk.transpose(0, 1, 3, 2)
    G[sl[1], sl[0], sl[3], sl[2]] = blk.transpose(1, 0, 3, 2)
    G[sl[2], sl[3], sl[0], sl[1]] = blk.transpose(2, 3, 0, 1)
    G[sl[3], sl[2], sl[0], sl[1]] = blk.transpose(3, 2, 0, 1)
    G[sl[2], sl[3], sl[1], sl[0]] = blk.transpose(2, 3, 1, 0)
    G[sl[3], sl[2], sl[1], sl[0]] = blk.transpose(3, 2, 1, 0)
