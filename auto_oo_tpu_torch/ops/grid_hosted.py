"""The hosted route's grid passes: one pass over Phi per call, at any D.

Port of auto_oo_tpu/ops/grid_hosted.py.  Where one full-Phi pass is
64e9 bytes or more ((16e,16o): n2 * D * 8 = 339 GB) the JAX package hosts
its grid kernels: the streamed chunk math of ops/grid.py runs as a host
loop of bounded segment programs, because its TPU worker killed any single
program of ~80 s and XLA's heap needed fixed shapes (grid_hosted.py:1-38).
An eager loop over grid A-row chunks has neither limit, so the segments,
their jit cache, the table warming and the environment knobs are gone;
the math stays:

* ``rdms_hosted``: (gamma, Gamma) from the chunk grams
  (``grid.rdms_rows``);
* ``ham_apply_hosted``: H|x> in SCATTER form.  Per chunk of grid rows,
  Y = C2 Phi_c + c1eff x is formed in SOURCE rows; its beta half reduces
  inside the chunk's rows (``gather_reduce_cols``), its alpha half adds
  into the full-height H|x> through the inverse maps (``scatter_rows``).
  One H-apply is one full-Phi pass whatever D, where the pair-blocked Y of
  ``grid.ham_apply_rows`` would cost ~n2 passes at (16e,16o) (one Y row is
  1.3 GB there);
* ``ham_and_rdms_hosted``: both of the above from one pass;
* ``ham_and_trdms_hosted``: H|t> and the transition-RDM grams of
  (psi, t) from one pass that builds both Phi chunks, so its default row
  chunk is half the single-Phi one;
* ``cross_hosted``: the Gram route's multi-state sweep (the JAX package's
  ``cross_hosted``, grid_hosted.py:460-582): one pass over the Phi chunks
  of a (B, Na, Nb) stack of states gives every <s_a|H|s_b> and the RDM
  grams of the first state against all, so the Hessian's tangent
  H-applies never run (``gram_fits`` says where the stack fits).

Each Phi chunk is ``grid._phi_chunk`` (one ``gather_two_spin`` launch for
both spin halves, over every state of a stack).  H|x> stays in the
state's dtype; the RDM and Gram accumulators are f64, and an f32 state's
grams are ``linalg.gram_last``'s (f32 products, f64 sums of pieces).  Row
chunks default to ``grid.stream_plan`` (the free device memory on the
card); the callers in models/oo_pqc.py pass the plans sized once at
construction.
"""

import torch

from . import grid as _grid
from .grid_kernels import gather_reduce_cols, scatter_rows
from .linalg import gram_last

# one full-Phi pass of this many f64 bytes or more takes the hosted route:
# the JAX package's threshold (auto_oo_tpu/ops/grid_hosted.py:63-75), so
# every sector takes the same route in both packages; (14e,14o) is 18.5
# GB, (16e,16o) 339 GB
_HOSTED_MIN_BYTES = 64e9


# the hosted route takes the Gram form where the (n_theta + 1, D) stack of
# psi and its tangent columns is at most this many bytes: the JAX
# package's budget (auto_oo_tpu/models/oo_pqc.py:763-768), so every
# problem takes the same form in both packages; (16e,16o) is 19.9 GB in
# f64 (per-tangent) and 9.9 GB in mixed precision (Gram)
_HOSTED_STACK_MAX_BYTES = 11e9


def needs_hosting(gm, itemsize=8):
    """True when one full-Phi pass over ``gm`` reaches the hosting
    threshold."""
    return gm.n2 * gm.Na * gm.Nb * itemsize >= _HOSTED_MIN_BYTES


def gram_fits(n_theta, dim, itemsize):
    """True when the Gram route's stack of n_theta + 1 states of ``dim``
    items of ``itemsize`` bytes fits its budget."""
    return (n_theta + 1) * dim * itemsize <= _HOSTED_STACK_MAX_BYTES


def _inverse_tables(gm, like):
    """``grid.inverse_alpha_maps`` as tensors for an operand ``like``
    (int64 dst, dsg in its dtype), cached on ``gm``; the plain scatter
    reads each chunk's window of columns (the JAX package's chunked
    inverse tables)."""
    def make():
        dst, dsg = _grid.inverse_alpha_maps(gm)
        return (torch.as_tensor(dst, device=like.device).long(),
                torch.as_tensor(dsg, device=like.device).to(like.dtype))
    return gm._cached(("inverse", like.device.type, like.dtype), make)


def _row_chunk(gm, row_chunk, B, like):
    return row_chunk or _grid.stream_plan(gm, B, like.element_size()).row_chunk


def _coefficients(c1eff, c2, gm, dtype):
    return (c1eff.reshape(gm.n2).to(dtype),
            c2.reshape(gm.n2, gm.n2).to(dtype))


def _ham_chunk(acc, phi_c, rows, c1, C2, gm, r0, r1):
    """acc += the part of sum_pq E_pq Y_pq that the grid rows [r0, r1) of
    Y = C2 Phi + c1 x feed, given that chunk of Phi (n2, R, Nb) and of x
    (R, Nb): the beta half lands in the same rows, the alpha half anywhere
    (the scatter through the inverse maps)."""
    n2, R, Nb = gm.n2, r1 - r0, gm.Nb
    yc = torch.matmul(C2, phi_c.reshape(n2, R * Nb)).reshape(n2, R, Nb)
    yc.addcmul_(c1[:, None, None], rows[None])
    srcA, sgnA, tB, srcB, sgnB, _ = gm.tables(yc)
    tA_k = _grid._row_tables(gm, yc, r0, r1)[2]
    scatter_rows(acc, yc, srcA, sgnA, tB, *_inverse_tables(gm, yc), r0)
    gather_reduce_cols(yc, srcB, sgnB, tA_k, out=acc[r0:r1],
                       lists=gm.col_lists())


def rdms_hosted(psi, gm, ncas, row_chunk=None, grid_order=True):
    """(gamma, Gamma) of a real sector state from one pass over Phi: the
    chunk grams of ``grid.rdms_rows``.  ``psi`` is GRID-ordered (canonical
    with ``grid_order=False``)."""
    if not grid_order:
        psi = _grid.to_grid(psi, gm)
    return _grid.rdms_rows(psi, gm, ncas, _row_chunk(gm, row_chunk, 1, psi))


def ham_apply_hosted(c1eff, c2, x, gm, row_chunk=None, grid_order=True):
    """H|x> (without the c0 constant) of a sector state x (D,), GRID-ordered
    (canonical with ``grid_order=False``, and then so is the result), in
    scatter form: one pass over Phi."""
    if not grid_order:
        x = _grid.to_grid(x, gm)
    c1, C2 = _coefficients(c1eff, c2, gm, x.dtype)
    xg = x.contiguous().reshape(gm.Na, gm.Nb)
    acc = torch.zeros_like(xg)
    for r0, r1 in _grid._row_chunks(gm.Na, _row_chunk(gm, row_chunk, 1, x)):
        phi_c = _grid._phi_chunk(xg, gm, r0, r1)
        _ham_chunk(acc, phi_c, xg[r0:r1], c1, C2, gm, r0, r1)
        del phi_c
    out = acc.reshape(-1)
    return out if grid_order else _grid.from_grid(out, gm)


def ham_and_rdms_hosted(c1eff, c2, x, gm, ncas, row_chunk=None):
    """(H|x>, gamma, Gamma) of a GRID-ordered sector state from ONE pass
    over Phi, each chunk feeding both the RDM grams and the scatter-form
    H-apply; the values of ``ham_apply_hosted`` and ``rdms_hosted``."""
    n2 = gm.n2
    c1, C2 = _coefficients(c1eff, c2, gm, x.dtype)
    xg = x.contiguous().reshape(gm.Na, gm.Nb)
    acc = torch.zeros_like(xg)
    gamma = x.new_zeros(n2, dtype=torch.float64)
    corr = x.new_zeros((n2, n2), dtype=torch.float64)
    for r0, r1 in _grid._row_chunks(gm.Na, _row_chunk(gm, row_chunk, 1, x)):
        phi_c = _grid._phi_chunk(xg, gm, r0, r1)
        phi_f = phi_c.reshape(n2, -1)
        gamma += gram_last(phi_f, xg[r0:r1].reshape(-1))
        corr += gram_last(phi_f, phi_f)
        _ham_chunk(acc, phi_c, xg[r0:r1], c1, C2, gm, r0, r1)
        del phi_c, phi_f
    gamma, Gamma = _grid.assemble_rdms(gamma, corr, ncas)
    return acc.reshape(-1), gamma, Gamma


def ham_and_trdms_hosted(c1eff, c2, psi, tpsi, gm, ncas, row_chunk=None):
    """(H|tpsi>, dgamma, dcorr) of a GRID-ordered state and tangent from
    ONE pass over grid row chunks that builds the Phi chunks of both: the
    transition-RDM grams of ``grid.transition_rdms_rows`` (f64
    accumulators) and the scatter-form H-apply of the tangent.  Two Phi
    chunks are live at once, so the default row chunk is sized for two
    states."""
    n2 = gm.n2
    c1, C2 = _coefficients(c1eff, c2, gm, tpsi.dtype)
    psig = psi.to(tpsi.dtype).contiguous().reshape(gm.Na, gm.Nb)
    tg = tpsi.contiguous().reshape(gm.Na, gm.Nb)
    acc = torch.zeros_like(tg)
    dgamma = tpsi.new_zeros(n2, dtype=torch.float64)
    dcorr = tpsi.new_zeros((n2, n2), dtype=torch.float64)
    for r0, r1 in _grid._row_chunks(gm.Na, _row_chunk(gm, row_chunk, 2,
                                                         tpsi)):
        phi_p = _grid._phi_chunk(psig, gm, r0, r1).reshape(n2, -1)
        phi_t = _grid._phi_chunk(tg, gm, r0, r1)
        phi_tf = phi_t.reshape(n2, -1)
        dgamma += (gram_last(phi_tf, psig[r0:r1].reshape(-1))
                   + gram_last(phi_p, tg[r0:r1].reshape(-1)))
        A = gram_last(phi_tf, phi_p)
        dcorr += A + A.T
        # the state's chunk is done: free it before Y is made
        del phi_p
        _ham_chunk(acc, phi_t, tg[r0:r1], c1, C2, gm, r0, r1)
        del phi_t, phi_tf
    return acc.reshape(-1), dgamma, dcorr


def cross_plan(gm, B, itemsize, resident=0):
    """The cross sweep's row chunk for B states: ``grid.stream_plan``
    sized for ~4 live (B, n2, rows, Nb) blocks (the JAX package's
    ``cross_stack_spec``, grid_hosted.py:515-524): the Phi chunk, its C2
    product and the GEMMs' partial sums."""
    return _grid.stream_plan(gm, 4 * B, itemsize, resident).row_chunk


def cross_hosted(states, c2, gm, ncas, row_chunk=None, tangent_grams=True):
    """The Gram route's sweep over a stack of B GRID-ordered states
    (state 0 is psi, the others its tangent columns): states (B, D) or
    (B, Na, Nb), one dtype.  Per chunk of grid rows, one
    ``gather_two_spin`` launch builds the (B, n2, rows, Nb) Phi chunk of
    every state, and GEMMs add into f64 accumulators

      M1     (B, B)       M1[a, b] = sum_pq <E_qp s_a, (C2 Phi(s_b))_pq>
      gsmall (B, B, n2)   gsmall[a, b, p] = <s_a, E_p s_b>
      cross0 (B, n2, n2)  cross0[b, p, q] = <E_p s_0, E_q s_b>

    so that <s_a|H|s_b> = M1[a, b] + gsmall[a, b] @ c1eff (gamma =
    gsmall[0, 0], corr = cross0[0]; the transition RDMs of s_b read
    gsmall[0, b], gsmall[b, 0] and cross0[b]).  The pair transpose
    E_pq^T = E_qp is an involution, so M1 takes C2's rows permuted once
    (sum_q <Phi_q(s_a), (C2[permT] Phi(s_b))_q>) where the JAX package
    gathered each chunk's Phi at permT.  With ``tangent_grams`` False
    only cross0[0] is summed (the rows b > 0 stay zero): the transition
    RDMs are read only when the problem has orbital rotations.  The row
    chunk defaults to ``cross_plan``."""
    n2, Na, Nb = gm.n2, gm.Na, gm.Nb
    S = states.contiguous().reshape(-1, Na, Nb)
    B = S.shape[0]
    if row_chunk is None:
        row_chunk = cross_plan(gm, B, S.element_size())
    C2t = c2.reshape(n2, n2)[gm.pair_perm()].to(S.dtype)
    M1 = S.new_zeros((B, B), dtype=torch.float64)
    gsmall = S.new_zeros((B, B, n2), dtype=torch.float64)
    cross0 = S.new_zeros((B, n2, n2), dtype=torch.float64)
    for r0, r1 in _grid._row_chunks(Na, row_chunk):
        phi = _grid._phi_chunk(S, gm, r0, r1).reshape(B, n2, -1)
        flat = phi.reshape(B * n2, -1)
        W = torch.matmul(C2t, phi)
        M1 += gram_last(phi.reshape(B, -1), W.reshape(B, -1))
        del W
        gsmall += gram_last(S[:, r0:r1].reshape(B, -1), flat).reshape(
            B, B, n2)
        if tangent_grams:
            cross0 += gram_last(phi[0], flat).reshape(n2, B, n2).transpose(
                0, 1)
        else:
            cross0[0] += gram_last(phi[0], phi[0])
        del phi, flat
    return M1, gsmall, cross0
