"""Direct grid-space gate construction — no flat pair tables at any point.

Numpy copy of auto_oo_tpu/simulator/grid_gates.py (``build_direct``).
It builds the _GridGate objects of a built-in ansatz directly on the
alpha/beta string lists in O(n_gates * (Na + Nb)) — the per-spin
factorization of each gate family is applied at construction.  In the
JAX package this construction is pinned against the golden-calibrated
flat programs for every ansatz family, closed- and open-shell
(tests/test_grid.py::test_direct_grid_gates_match_factorized); the port's
grid states are pinned against the JAX package's.

Semantics mirror simulator/gates.py exactly:
* fermionic gates apply the ordered mode sequence (a_s, a_r, a+_q, a+_p)
  accumulating a Jordan-Wigner parity BEFORE each flip; the parity of
  the full determinant splits as parity(alpha part) * parity(beta part)
  at every step because the mask popcounts are additive over disjoint
  bit sets, and each side's bits evolve only at that side's steps;
* qubit-defined gates (DoubleExcitation / SingleExcitation with an
  explicit string mask) are occupancy patterns with a static sign.
"""

import numpy as np

from ..ops import fermion
from . import gates as G
from .grid_program import _GridGate, GridGateProgram, _spin_mask


def _parity(x, mask):
    return 1 - 2 * (fermion.popcount(np.asarray(x) & mask) & 1)


def _side_sequence(strings, steps, side_mask, nm):
    """Apply ordered (mode, 'a'|'c') steps to one spin side's strings.

    Returns (ok, src, dst, sgn): validity mask, source strings, result
    strings and the side-restricted JW parity product — for EVERY step
    the parity of occupied in-side modes below the step's mode is
    accumulated (evaluated on the current state, before the flip),
    matching gates.py's full-determinant parity restricted to this side.
    """
    cur = strings.astype(np.int64).copy()
    ok = np.ones(strings.size, dtype=bool)
    sgn = np.ones(strings.size, dtype=np.int64)
    for mode, kind in steps:
        bit = 1 << (nm - 1 - mode)
        inside = (bit & side_mask) != 0
        if inside:
            if kind == "a":
                ok &= (cur & bit) != 0
            else:
                ok &= (cur & bit) == 0
        m = G._mask_below(nm, mode) & side_mask
        if m:
            sgn = sgn * _parity(cur, m)
        if inside:
            cur = cur ^ bit
    return ok, strings, cur, sgn


def _side_pattern(strings, set_modes, clear_modes, flip_modes,
                  parity_mask, side_mask, nm):
    """Occupancy-pattern gate side (qubit-defined gates): conditions and
    flips restricted to in-side modes, sign from a static parity mask."""
    ok = np.ones(strings.size, dtype=bool)
    flip = 0
    for mode in set_modes:
        bit = 1 << (nm - 1 - mode)
        if bit & side_mask:
            ok &= (strings & bit) != 0
    for mode in clear_modes:
        bit = 1 << (nm - 1 - mode)
        if bit & side_mask:
            ok &= (strings & bit) == 0
    for mode in flip_modes:
        bit = 1 << (nm - 1 - mode)
        if bit & side_mask:
            flip |= bit
    sgn = _parity(strings, parity_mask & side_mask)
    return ok, strings, strings ^ flip, sgn


def _assemble(A, B, resA, resB, half, param, gsign):
    okA, srcA, dstA, sgnA = resA
    okB, srcB, dstB, sgnB = resB
    g = _GridGate()
    if not (okA.any() and okB.any()):
        g.empty = True
        return g
    g.empty = False
    src_a, dst_a, sA = srcA[okA], dstA[okA], sgnA[okA]
    src_b, dst_b, sB = srcB[okB], dstB[okB], sgnB[okB]
    ia_s = np.searchsorted(A, src_a)
    ia_d = np.searchsorted(A, dst_a)
    ib_s = np.searchsorted(B, src_b)
    ib_d = np.searchsorted(B, dst_b)
    assert np.array_equal(A[ia_d], dst_a) and np.array_equal(B[ib_d],
                                                             dst_b), \
        "gate left the sector string lists"
    g.Ai_src = ia_s.astype(np.int32)
    g.Ai_dst = ia_d.astype(np.int32)
    g.Bj_src = ib_s.astype(np.int32)
    g.Bj_dst = ib_d.astype(np.int32)
    # global sign folded into the alpha side (same convention as the
    # factorizer's rank-1 split — only the product sA x sB is defined)
    g.sA = (sA * int(gsign)).astype(np.int8)
    g.sB = sB.astype(np.int8)
    g.alpha_identity = (src_a.size == A.size
                        and np.array_equal(dst_a, src_a))
    g.beta_identity = (src_b.size == B.size
                       and np.array_equal(dst_b, src_b))
    g.half = float(half)
    g.param = int(param)
    return g


class _Factory:
    """Gate factory with the same call surface as simulator/gates.py,
    producing _GridGate objects on (A, B) string lists."""

    def __init__(self, ncas, up_then_down=False):
        if isinstance(up_then_down, bool) and up_then_down:
            raise NotImplementedError(
                "grid gates assume the interleaved sector convention")
        self.nm = 2 * ncas
        self.amask = _spin_mask(ncas, 0, up_then_down)
        self.bmask = _spin_mask(ncas, 1, up_then_down)
        self.A = None
        self.B = None

    def set_strings(self, A, B):
        self.A = np.asarray(A, dtype=np.int64)
        self.B = np.asarray(B, dtype=np.int64)

    def _seq(self, steps, half, param, sign_flip):
        return _assemble(
            self.A, self.B,
            _side_sequence(self.A, steps, self.amask, self.nm),
            _side_sequence(self.B, steps, self.bmask, self.nm),
            half, param, sign_flip)

    def fermionic_double_pairs(self, p, q, r, s, nm, param, half=1.0,
                               sign_flip=1.0, dets=None):
        return self._seq([(s, "a"), (r, "a"), (q, "c"), (p, "c")],
                         half, param, sign_flip)

    def fermionic_single_pairs(self, p, r, nm, param, half=1.0,
                               sign_flip=1.0, dets=None):
        return self._seq([(r, "a"), (p, "c")], half, param, sign_flip)

    def double_excitation_pairs(self, wires, nm, param, sign_flip=1.0,
                                dets=None):
        w0, w1, w2, w3 = wires
        mk = lambda S: _side_pattern(  # noqa: E731
            S, (w2, w3), (w0, w1), (w0, w1, w2, w3), 0,
            self.amask if S is self.A else self.bmask, self.nm)
        return _assemble(self.A, self.B, mk(self.A), mk(self.B),
                         0.5, param, sign_flip)

    def single_excitation_pairs(self, wires, nm, param, half=0.5,
                                sign_flip=1.0, string_mask=0, dets=None):
        w0, w1 = wires
        mk = lambda S: _side_pattern(  # noqa: E731
            S, (w1,), (w0,), (w0, w1), string_mask,
            self.amask if S is self.A else self.bmask, self.nm)
        return _assemble(self.A, self.B, mk(self.A), mk(self.B),
                         half, param, sign_flip)

    def orbital_rotation_pairs(self, wires, nm, param, sign_flip=1.0,
                               with_string=True, dets=None):
        w0, w1, w2, w3 = wires
        sm_a = (1 << (nm - 1 - w1)) if with_string else 0
        sm_b = (1 << (nm - 1 - w2)) if with_string else 0
        return [self.single_excitation_pairs((w0, w2), nm, param,
                                             half=0.5,
                                             sign_flip=sign_flip,
                                             string_mask=sm_a),
                self.single_excitation_pairs((w1, w3), nm, param,
                                             half=0.5,
                                             sign_flip=sign_flip,
                                             string_mask=sm_b)]


def build_direct(ncas, nelecas, ansatz, n_layers=3, add_singles=False,
                 k=1, up_then_down=False, device=None):
    """GridGateProgram for a built-in ansatz family, constructed directly
    on the string lists (O(n_gates * (Na + Nb)) host work); its tables
    live on ``device``."""
    from ..ops.grid import grid_strings
    from . import ansatze as Ans

    A, B = grid_strings(ncas, nelecas, up_then_down)
    fac = _Factory(ncas, up_then_down)
    fac.set_strings(A, B)
    nm = 2 * ncas
    gate_list = []
    if ansatz == "ucc":
        singles, doubles = Ans.excitations(nelecas, nm)
        ns = len(singles) if add_singles else 0
        for i, (s, r, q, p) in enumerate(doubles):
            gate_list.append(fac.fermionic_double_pairs(
                p, q, r, s, nm, param=ns + i, half=0.5,
                sign_flip=Ans.FD_SIGN))
        if add_singles:
            for j, (r, p) in enumerate(singles):
                gate_list.append(fac.fermionic_single_pairs(
                    p, r, nm, param=j, half=0.5, sign_flip=Ans.FS_SIGN))
        n_params = ns + len(doubles)
    elif ansatz == "np_fabric":
        blocks = Ans.gatefabric_layout(nm)
        n_blocks = len(blocks)
        for layer in range(n_layers):
            for b, wires in enumerate(blocks):
                p_theta = (layer * n_blocks + b) * 2
                de = fac.double_excitation_pairs(
                    wires, nm, p_theta, sign_flip=Ans.DE_SIGN)
                orot = fac.orbital_rotation_pairs(
                    wires, nm, p_theta + 1, sign_flip=Ans.OR_SIGN,
                    with_string=Ans.OR_STRING)
                if Ans.FABRIC_ORBROT_FIRST:
                    gate_list.extend(orot)
                    gate_list.append(de)
                else:
                    gate_list.append(de)
                    gate_list.extend(orot)
        n_params = n_layers * n_blocks * 2
    elif ansatz == "kupccd":
        d_wires = Ans.generalized_pair_doubles(list(range(nm)))
        for layer in range(k):
            for i, (w1, w2) in enumerate(d_wires):
                s, r = w1[0], w1[-1]
                q, p = w2[0], w2[-1]
                gate_list.append(fac.fermionic_double_pairs(
                    p, q, r, s, nm, param=layer * len(d_wires) + i,
                    half=0.5, sign_flip=Ans.FD_SIGN))
        n_params = k * len(d_wires)
    else:
        raise ValueError(f"no direct grid builder for ansatz {ansatz!r}")

    init_det, _ = fermion.hf_bitstring(ncas, nelecas)
    ia = int(np.searchsorted(A, init_det & fac.amask))
    jb = int(np.searchsorted(B, init_det & fac.bmask))
    assert A[ia] == (init_det & fac.amask) and B[jb] == (init_det
                                                        & fac.bmask)
    init_grid = ia * B.size + jb
    return GridGateProgram(gate_list, n_params, init_grid, A.size, B.size,
                           device=device)
