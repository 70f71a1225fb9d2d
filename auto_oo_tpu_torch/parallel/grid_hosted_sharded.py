"""Hosted x row-sharded string-grid engine: the (18e,18o) axis.

Port of auto_oo_tpu/parallel/grid_hosted_sharded.py.  Where no rank can
hold one whole statevector ((18e,18o): D = 2,363,904,400, 18.9 GB in
f64), the row-sharded engine's all_gather of x cannot run, so the state
lives in BOTH string layouts, each sharded over one mesh axis of n
ranks:

    N layout: rows of x (Na_pad / n, Nb), this rank's ALPHA rows
    T layout: columns of x (Na, Nb_pad / n), this rank's BETA columns

Every operator factor is local in one of them (the spin factorization of
ops/grid.py): beta-spin E_pq factors gather inside the rows of the N
layout, alpha-spin ones inside the columns of the T layout.  Per segment
(a chunk of every rank's local alpha rows):

  1. the segment's alpha Phi is built in the T layout, one
     ``gather_rows_scaled`` launch on the rank's (Na, Nb/n) column slab
     over every rank's segment rows, and moved to the N layout by ONE
     ``all_to_all``;
  2. the beta Phi is built in the N layout (``gather_rows_scaled`` on the
     chunk's transposed rows, as the TPU wrappers do) and added; the RDM
     grams consume the whole Phi chunk;
  3. for the Hamiltonian apply, Y = C2 Phi + c1eff x on the chunk: its
     beta half reduces in place into the chunk's rows
     (``gather_reduce_cols``), its alpha half goes to the T layout by one
     ``all_to_all`` and is added into a (Na_pad, Nb/n) column-slab
     accumulator by ``scatter_rows`` through the inverse alpha maps, one
     launch per source rank's block of rows;
  4. one final D-sized ``all_to_all`` folds the slab accumulator onto the
     N-layout output.

The callables take and return the rank's N-layout rows, as the JAX
function's sharded arrays are: no rank ever holds a whole state.  The T
layout is built from the N rows by one ``all_to_all`` per call.
``rows`` cuts a rank's rows out of a whole state and ``gather``
assembles one (one all_gather); both are for tests and dry runs, where
a whole state fits.  The RDM grams are summed over the ranks once, after
the last segment (the JAX package sums each segment's).
"""

import torch
import torch.nn.functional as F

from ..ops import grid_hosted as _gh
from ..ops.grid import GridMaps
from ..ops.grid_kernels import (gather_reduce_cols, gather_rows_scaled,
                                scatter_rows)
from ..ops.linalg import gram_last
from .distributed import Axis, all_gather, all_reduce, all_to_all
from .grid_sharded import padded_maps


def hosted_sharded_fns(gm, mesh, axis="row", dtype=torch.float64,
                       row_chunk=None):
    """The hosted x row-sharded engine of one sector, on the ``axis`` of
    ``mesh`` (a DeviceMesh), for states in ``dtype`` (float64 or float32).

    Returns a dict of host-driven callables over this rank's N-layout
    rows ``xn``, (Na_pad / n, Nb) of the (Na, Nb) GRID-ordered state
    padded with zero rows to Na_pad (or the same flat):

      rdms(xn)                   -> (gamma (n2,), corr (n2, n2)), the raw
                                    grid gram accumulators, float64, whole
                                    on every rank (``grid.assemble_rdms``
                                    gives the RDMs)
      ham_apply(c1eff, c2, xn)   -> this rank's rows of H|psi> (no c0),
                                    (Na_pad / n, Nb)
      layouts(xn)                -> (xn, xt): the rows and the T-layout
                                    column slab (Na, Nb_pad / n), by one
                                    all_to_all
      rows(psi)                  -> this rank's rows of a whole flat
                                    grid-order state
      gather(x_rows)             -> the whole flat grid-order state of
                                    every rank's rows (one all_gather)
      memory_budget(n_dev, itemsize) -> per-rank bytes of each object
      row_chunk                  -> alpha rows per rank per segment

    ``row_chunk`` defaults to the JAX package's policy: ~4 live chunk
    blocks of n2 * Nb items per row within 1.5e9 bytes."""
    if not isinstance(gm, GridMaps):
        raise ValueError("hosted_sharded_fns needs string-grid maps")
    ax = Axis(mesh, axis)
    n = ax.size
    n2, Na, Nb = gm.n2, gm.Na, gm.Nb
    pm = padded_maps(gm, n)
    rows_loc, (lo, hi) = ax.block(Na)
    nbloc, (c0, c1) = ax.block(Nb)
    Na_pad, Nb_pad = rows_loc * n, nbloc * n
    itemsize = torch.empty((), dtype=dtype).element_size()
    if row_chunk is None:
        row_chunk = max(1, int(1.5e9 // max(1, 4 * n2 * Nb * itemsize)))
    row_chunk = max(1, min(int(row_chunk), rows_loc))
    segments = [(r0, min(rows_loc, r0 + row_chunk))
                for r0 in range(0, rows_loc, row_chunk)]

    def tables(like):
        """(srcA, sgnA, dst, dsg) of the padded alpha maps, (srcB, sgnB)
        of the beta maps, tA (n2, Na_pad) and this rank's tB columns
        (n2, Nb/n, padded), for an operand ``like``."""
        srcA, sgnA, tB, srcB, sgnB, tA = pm.tables(like)
        tB_l = F.pad(tB, (0, Nb_pad - Nb))[:, c0:c1].contiguous()
        return (srcA, sgnA) + _gh._inverse_tables(pm, like) + (
            srcB, sgnB, tA, tB_l)

    def lanes(r0, r1, like):
        """Every rank's segment rows [r0, r1), rank-major: the global
        padded rows of the T-layout gather's lanes."""
        starts = torch.arange(n, device=like.device) * rows_loc
        return (starts[:, None] + torch.arange(r0, r1, device=like.device)
                ).reshape(-1)

    def rows(psi):
        """This rank's rows (rows, Nb) of a whole flat grid-order state."""
        xg = torch.as_tensor(psi, device=gm.device).reshape(Na, Nb)
        blk = xg[lo:min(hi, Na)].to(dtype)
        return F.pad(blk, (0, 0, 0, rows_loc - blk.shape[0])).contiguous()

    def gather(x_rows):
        """Every rank's rows -> the whole flat grid-order state."""
        return all_gather(x_rows.reshape(rows_loc, Nb), ax)[:Na].reshape(-1)

    def layouts(xn):
        """This rank's rows -> (xn (rows, Nb), xt (Na, Nb/n)): block e of
        the padded columns goes to rank e, which stacks every rank's rows
        of its columns."""
        xn = torch.as_tensor(xn, device=gm.device).to(dtype).reshape(
            rows_loc, Nb).contiguous()
        send = xn.new_zeros((n, rows_loc, nbloc))
        for e in range(n):
            w = min(nbloc, Nb - e * nbloc)
            if w > 0:
                send[e, :, :w] = xn[:, e * nbloc:e * nbloc + w]
        xt = all_to_all(send, ax).reshape(Na_pad, nbloc)[:Na]
        return xn, xt

    def phi_chunk(xn, xt, tabs, r0, r1):
        """This rank's Phi of its segment rows [r0, r1) in the N layout,
        (n2, chunk, Nb): the alpha half in the T layout for every rank's
        segment, then one all_to_all; the beta half on the chunk's own
        rows."""
        srcA, sgnA, _dst, _dsg, srcB, sgnB, tA, tB_l = tabs
        chunk = r1 - r0
        ln = lanes(r0, r1, xt)
        # (n2, n * chunk, Nb/n): rank e's lanes are block e
        phiT = gather_rows_scaled(xt, srcA.index_select(1, ln).contiguous(),
                                  sgnA.index_select(1, ln).contiguous(),
                                  tB_l)
        send = phiT.reshape(n2, n, chunk, nbloc).transpose(0, 1)
        recv = all_to_all(send, ax)            # block e: rank e's columns
        phi = recv.permute(1, 2, 0, 3).reshape(n2, chunk, Nb_pad)[..., :Nb]
        tA_me = tA[:, lo + r0:lo + r1].contiguous()
        pb = gather_rows_scaled(xn[r0:r1].T.contiguous(), srcB, sgnB, tA_me)
        return phi + pb.transpose(-1, -2), tA_me

    def rdms(xn):
        """The raw gram accumulators (gamma (n2,), corr (n2, n2)) of
        ``grid.rdms_rows``, from this rank's rows."""
        xn, xt = layouts(xn)
        tabs = tables(xn)
        gamma = xn.new_zeros(n2, dtype=torch.float64)
        corr = xn.new_zeros((n2, n2), dtype=torch.float64)
        for r0, r1 in segments:
            phi, _ = phi_chunk(xn, xt, tabs, r0, r1)
            pf = phi.reshape(n2, -1)
            gamma += gram_last(pf, xn[r0:r1].reshape(-1).conj()).real
            corr += gram_last(pf.conj(), pf).real
            del phi, pf
        return all_reduce(gamma, ax), all_reduce(corr, ax)

    def ham_apply(c1eff, c2, xn):
        """This rank's rows (rows, Nb) of H|psi> (no c0), from its rows
        of psi: equal to those of ``grid_hosted.ham_apply_hosted``."""
        xn, xt = layouts(xn)
        tabs = tables(xn)
        srcA, sgnA, dst, dsg, srcB, sgnB, _tA, tB_l = tabs
        c1, C2 = _gh._coefficients(c1eff, c2, gm, xn.dtype)
        out_n = torch.zeros_like(xn)                       # (rows, Nb)
        out_t = xn.new_zeros((Na_pad, nbloc))               # column slab
        lists = gm.col_lists()
        for r0, r1 in segments:
            chunk = r1 - r0
            phi, tA_me = phi_chunk(xn, xt, tabs, r0, r1)
            Y = torch.matmul(C2, phi.reshape(n2, -1)).reshape(n2, chunk, Nb)
            Y.addcmul_(c1[:, None, None], xn[None, r0:r1])
            del phi
            # beta half: in place into the chunk's own rows
            gather_reduce_cols(Y, srcB, sgnB, tA_me, out=out_n[r0:r1],
                               lists=lists)
            # alpha half: each rank's beta columns to it, then the
            # scatter of every rank's block of source rows
            send = F.pad(Y, (0, Nb_pad - Nb)).reshape(
                n2, chunk, n, nbloc).permute(2, 0, 1, 3)
            recv = all_to_all(send, ax)
            del Y, send
            for e in range(n):
                scatter_rows(out_t, recv[e], srcA, sgnA, tB_l, dst, dsg,
                             e * rows_loc + r0)
            del recv
        del xt
        # fold: row block d of the slab accumulator to rank d, whose
        # block e is rank e's columns of its rows
        back = all_to_all(out_t.reshape(n, rows_loc, nbloc), ax)
        del out_t
        for e in range(n):
            w = min(nbloc, Nb - e * nbloc)
            if w > 0:
                out_n[:, e * nbloc:e * nbloc + w] += back[e, :, :w]
        return out_n

    def memory_budget(n_dev_q=None, itemsize_q=None):
        """Per-rank bytes of the engine's persistent and transient objects
        (the (18e,18o)-on-a-mesh feasibility table of the JAX package):
        the rank's input rows, its T slab, the two output accumulators,
        and the chunk blocks of a segment.  The all_to_all buffers of the
        T build and of the fold (one state block each) are live only
        outside the segments, when the chunk blocks are not."""
        nd = n_dev_q or n
        isz = itemsize_q or itemsize
        na_p = -(-Na // nd) * nd
        nb_p = -(-Nb // nd) * nd
        state_n = na_p // nd * Nb * isz
        state_t = nb_p // nd * Na * isz
        chunk_block = n2 * nd * row_chunk * Nb * isz // nd
        return {"n_dev": nd, "x_layout_n": state_n, "x_layout_t": state_t,
                "out_accum_n": state_n, "out_accum_t": state_t,
                "phi_chunk_block": chunk_block, "live_chunk_blocks": 4,
                "total_est": 2 * (state_n + state_t) + 4 * chunk_block}

    return {"rdms": rdms, "ham_apply": ham_apply,
            "memory_budget": memory_budget, "row_chunk": row_chunk,
            "layouts": layouts, "rows": rows, "gather": gather}
