"""The string-grid gate kernels: the gate steps of the sector circuits'
sweeps in place, CUDA for the card, plain PyTorch for the CPU.

A gate of simulator/grid_program.py rotates the element pairs
(X[Ai_src[k], Bj_src[l]], X[Ai_dst[k], Bj_dst[l]]) of a string grid X
(Na, Nb) with sign sA[k] sB[l] (``GateTables`` holds its tables on the
device).  Three kernels step it in place over a batch of grids (L lanes
of M grids each, a (L, M, Na, Nb) view whose rows are contiguous), each
lane with its own (cos, sin) read from device memory:

* ``gate_rotate``: the rotation (or its inverse) of every grid;
* ``gate_generator_add``: Dst += coef G Src, G the rotation's generator;
* ``gate_adjoint_step``: one step of the reverse sweeps
  (``pair_row``, ``hessian_dot``) in one pass: the dot products h <Q_t, G
  P> + h <E, G D_t> added to ``out``, the inverse rotation of every
  operand and the generator terms of the tangent ``ti``.

The CUDA source is ``csrc/grid_gates.cu``; its header comment says what
bounds the kernels on an H100 and what the design does about it.  The
library is compiled with ``nvcc`` at first use (ops/cuda_build.py).

Dispatch is by the device of the operand, and nothing else: a CPU tensor
runs the plain version beside each kernel (``index_select`` of the
gate's blocks, then ``index_copy_`` / ``index_add_`` into the operand);
a CUDA tensor launches the kernel, or raises.  No path falls back from
the card to the plain version.  ``blocks`` and ``put`` are also the
functional (out-of-place) step that the sweeps run under autograd.

Launches count in ``grid_kernels.LAUNCHES`` and, while spans record
(utils/observe.py), each is a ``kernel`` span named by its kernel.
"""

import ctypes
import os

import numpy as np
import torch

from ..utils import observe as _observe
from . import grid_kernels as _gk
from .cuda_build import CSRC_DIR, I32, I64, PTR, CudaLibrary

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

# a gate's tables: rs, rd, cs, cd, sA, sB; ka, kb, Nb
_GATE = [PTR] * 6 + [I32] * 3

#: the kernel library, built from csrc/grid_gates.cu at first use
LIBRARY = CudaLibrary(
    os.path.join(CSRC_DIR, "grid_gates.cu"),
    {**{f"grid_gate_rotate_{sfx}":
        # X, its lane and grid strides, L, M; the gate; c, s, their lane
        # stride, the direction, the vector width; the stream
        [PTR, I64, I64, I32, I32] + _GATE + [PTR, PTR, I32, I32, I32, PTR]
        for sfx in _SUFFIX.values()},
     **{f"grid_gate_generator_add_{sfx}":
        # Dst, its lane stride, Src, its lane stride, L; the gate; coef,
        # its sign, the vector width; the stream
        [PTR, I64, PTR, I64, I32] + _GATE + [PTR, I32, I32, PTR]
        for sfx in _SUFFIX.values()},
     **{f"grid_gate_adjoint_step_{sfx}":
        # P, E, D, Q with their lane (and tangent) strides, L, nt; the
        # gate; c, s, their lane stride; part, out, its strides, h; ti,
        # coef, its sign, the vector width; the stream
        [PTR, I64, PTR, I64, PTR, I64, I64, PTR, I64, I64, I32, I32]
        + _GATE + [PTR, PTR, I32, PTR, PTR, I64, I64, ctypes.c_double,
                   I32, PTR, I32, I32, PTR]
        for sfx in _SUFFIX.values()}})

#: the kernels, each counted in ``grid_kernels.LAUNCHES``
KERNELS = ("gate_rotate", "gate_generator_add", "gate_adjoint_step")
for _name in KERNELS:
    _gk.LAUNCHES.setdefault(_name, 0)

# gridDim.y of a launch (lanes x grids)
_GRID_Y_MAX = 65535


class GateTables:
    """One string-grid gate on ``device``: its row pairs (``Ai_src``,
    ``Ai_dst``, int64 (ka,)), column pairs (``Bj_src``, ``Bj_dst``, int64
    (kb,)), sign factors ``sA`` (ka,) and ``sB`` (kb,) (int8), on a grid
    (Na, Nb).  On an identity axis (``alpha_identity``: every row pairs with
    itself, ka = Na; ``beta_identity``: every column, kb = Nb) the tables
    are aranges; a gate with both tables is a ``subgrid`` gate.  ``card``
    holds the kernels' arguments on a CUDA device (int32 tables, none on an
    identity axis).  A sign matrix of more than ``dense_max`` elements is
    kept as its factors (``signs``)."""

    __slots__ = ("Na", "Nb", "device", "Ai_src", "Ai_dst", "Bj_src",
                 "Bj_dst", "sA", "sB", "alpha_identity", "beta_identity",
                 "subgrid", "ka", "kb", "card", "dense_max", "_keep",
                 "_sgn")

    def __init__(self, g, Na, Nb, device, dense_max):
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        self.Na, self.Nb = int(Na), int(Nb)
        self.Ai_src, self.Ai_dst, self.Bj_src, self.Bj_dst = (
            dev(a, torch.int64) for a in (g.Ai_src, g.Ai_dst, g.Bj_src,
                                          g.Bj_dst))
        self.sA, self.sB = dev(g.sA, torch.int8), dev(g.sB, torch.int8)
        self.device = self.sA.device
        self.alpha_identity = bool(g.alpha_identity)
        self.beta_identity = bool(g.beta_identity)
        self.subgrid = not (self.alpha_identity or self.beta_identity)
        self.ka, self.kb = self.Ai_src.numel(), self.Bj_src.numel()
        self.dense_max = dense_max
        self._sgn = {}
        self._keep = ()
        self.card = ()
        if self.device.type == "cuda":
            rows = (() if self.alpha_identity else
                    (self.Ai_src.int(), self.Ai_dst.int()))
            cols = (() if self.beta_identity else
                    (self.Bj_src.int(), self.Bj_dst.int()))
            self._keep = rows + cols
            ptr = [t.data_ptr() for t in self._keep]
            rs, rd = ptr[:2] if rows else (None, None)
            cs, cd = ptr[-2:] if cols else (None, None)
            self.card = (rs, rd, cs, cd, self.sA.data_ptr(),
                         self.sB.data_ptr(), self.ka, self.kb, self.Nb)

    def signs(self, dtype):
        """The (ka, kb) sign matrix sA x sB in ``dtype``, or for a large
        gate its factors (sA (ka, 1), sB (1, kb)); built once per dtype."""
        hit = self._sgn.get(dtype)
        if hit is None:
            a, b = self.sA.to(dtype), self.sB.to(dtype)
            hit = self._sgn[dtype] = (
                a[:, None] * b[None, :] if self.ka * self.kb <=
                self.dense_max else (a[:, None], b[None, :]))
        return hit


def gate_bytes(tab, itemsize, rotated=1, read=0, grids=1):
    """The bytes a launch on ``grids`` grids must move: each touched
    element (2 ka kb a grid) of the ``rotated`` operands read and written
    once, of the ``read`` operands read once, and the kernel's tables
    once (the bound of csrc/grid_gates.cu)."""
    touched = 2 * tab.ka * tab.kb
    tables = tab.ka + tab.kb + 4 * sum(t.numel() for t in tab._keep)
    return grids * touched * itemsize * (2 * rotated + read) + tables


# ---- the plain versions (the CPU path, the functional step, and the
# ---- reference on the card) ------------------------------------------------


def sgn_mul(sgn, x):
    """sgn * x for a sign matrix or its factors (the signs are +-1, so both
    give the same bits)."""
    if isinstance(sgn, tuple):
        return (x * sgn[0]) * sgn[1]
    return sgn * x


def blocks(X, tab):
    """The (va, vb) blocks of X (..., Na, Nb) that the gate rotates."""
    if tab.beta_identity:
        return X.index_select(-2, tab.Ai_src), X.index_select(-2, tab.Ai_dst)
    if tab.alpha_identity:
        return X.index_select(-1, tab.Bj_src), X.index_select(-1, tab.Bj_dst)
    return (X.index_select(-2, tab.Ai_src).index_select(-1, tab.Bj_src),
            X.index_select(-2, tab.Ai_dst).index_select(-1, tab.Bj_dst))


def put(X, tab, da, db, add, in_place=False):
    """X with the gate's blocks replaced by (add=False) or increased by
    (add=True) da / db: out of place, or written into X (``in_place``)."""
    if tab.beta_identity or tab.alpha_identity:
        dim, ia, ib = ((-2, tab.Ai_src, tab.Ai_dst) if tab.beta_identity
                       else (-1, tab.Bj_src, tab.Bj_dst))
        if in_place:
            if add:
                return X.index_add_(dim, ia, da).index_add_(dim, ib, db)
            return X.index_copy_(dim, ia, da).index_copy_(dim, ib, db)
        if add:
            return X.index_add(dim, ia, da).index_add(dim, ib, db)
        return X.index_copy(dim, ia, da).index_copy(dim, ib, db)
    # subgrid: scatter the (ka, kb) blocks into zero (ka, Nb) row blocks,
    # then row scatter-add (A_src/A_dst disjoint, or columns disjoint — a
    # delta-add is safe in every case)
    rows = X.shape[:-2] + (tab.ka, tab.Nb)
    DA = torch.zeros(rows, dtype=X.dtype, device=X.device).index_copy(
        -1, tab.Bj_src, da)
    DB = torch.zeros(rows, dtype=X.dtype, device=X.device).index_copy(
        -1, tab.Bj_dst, db)
    if in_place:
        return X.index_add_(-2, tab.Ai_src, DA).index_add_(-2, tab.Ai_dst, DB)
    return X.index_add(-2, tab.Ai_src, DA).index_add(-2, tab.Ai_dst, DB)


def g_dot(Ct, Y, tab):
    """<Ct, G Y> over the grid axes (the leading axes broadcast)."""
    cta, ctb = blocks(Ct, tab)
    ya, yb = blocks(Y, tab)
    sgn = tab.signs(Y.dtype)
    return ((ctb * sgn_mul(sgn, ya)).sum(dim=(-2, -1))
            - (cta * sgn_mul(sgn, yb)).sum(dim=(-2, -1)))


def _lanes(v):
    return v.reshape(-1, 1, 1, 1)


def gate_rotate_plain(X, tab, c, s, inverse=False):
    """``gate_rotate`` in plain PyTorch: X (L, M, Na, Nb), c and s (L,)
    or (1,); returns X."""
    c, s = _lanes(c), _lanes(-s if inverse else s)
    va, vb = blocks(X, tab)
    ss = sgn_mul(tab.signs(X.dtype), s)
    if tab.subgrid:
        cm1 = c - 1.0
        return put(X, tab, cm1 * va - ss * vb, ss * va + cm1 * vb, add=True,
                   in_place=True)
    return put(X, tab, c * va - ss * vb, ss * va + c * vb, add=False,
               in_place=True)


def gate_generator_add_plain(Dst, Src, tab, coef, scale=1):
    """``gate_generator_add`` in plain PyTorch: Dst and Src (L, 1, Na, Nb),
    coef a one-element tensor; returns Dst."""
    k = (-coef if scale < 0 else coef).reshape(())
    va, vb = blocks(Src, tab)
    cs = sgn_mul(tab.signs(Dst.dtype), k)
    return put(Dst, tab, -cs * vb, cs * va, add=True, in_place=True)


def gate_adjoint_step_plain(P, Q, D, E, tab, c, s, out=None, h=0.0, ti=-1,
                            coef=None, scale=-1, part=None):
    """``gate_adjoint_step`` in plain PyTorch, in the functional sweeps'
    order: the dot products into ``out``, the inverse rotation of each
    operand, then the generator terms; returns out."""
    if out is not None:
        d = g_dot(Q, P, tab)
        if D is not None:
            d = d + g_dot(E, D, tab)
        out += h * d
    for X in (P, D, Q, E):
        if X is not None:
            gate_rotate_plain(X, tab, c, s, inverse=True)
    if ti >= 0:
        gate_generator_add_plain(D[:, ti:ti + 1], P, tab, coef, scale)
        gate_generator_add_plain(Q[:, ti:ti + 1], E, tab, coef, scale)
    return out


# ---- wrappers --------------------------------------------------------------


def _launch(kern, dtype, *args):
    with _observe.span("kernel", kern):
        LIBRARY.launch(f"grid_{kern}_{_SUFFIX[dtype]}", *args)
    _gk.LAUNCHES[kern] += 1


def _grids(name, X, tab, dtype=None, lanes=None, per_lane=None):
    """Check a (L, M, Na, Nb) operand of ``tab`` with contiguous rows;
    returns (L, M)."""
    if X.dtype not in _SUFFIX or (dtype is not None and X.dtype != dtype):
        raise TypeError(f"{name}: operand dtype {X.dtype}")
    if X.device != tab.device:
        raise ValueError(f"{name}: operand on {X.device}, gate on "
                         f"{tab.device}")
    if (X.dim() != 4 or tuple(X.shape[2:]) != (tab.Na, tab.Nb)
            or X.stride(3) != 1 or X.stride(2) != tab.Nb):
        raise ValueError(f"{name}: operand {tuple(X.shape)} strides "
                         f"{X.stride()} is no (L, M, {tab.Na}, {tab.Nb}) "
                         "batch of grids with contiguous rows")
    L, M = X.shape[:2]
    if (lanes is not None and L != lanes) or (per_lane is not None
                                              and M != per_lane):
        raise ValueError(f"{name}: operand {tuple(X.shape)}, expected "
                         f"{lanes} lanes x {per_lane} grids")
    return L, M


def _trig(name, c, s, X, L):
    """Check the lanes' (c, s); returns their lane stride."""
    for v in (c, s):
        if (v.dtype != X.dtype or v.device != X.device or v.dim() != 1
                or v.stride(0) != 1 or v.numel() not in (1, L)):
            raise ValueError(f"{name}: (c, s) must be contiguous (1,) or "
                             f"({L},) {X.dtype} tensors on {X.device}")
    return 1 if c.numel() > 1 else 0


def _vec(tab, *ops):
    """Elements per load: a 16-byte vector (8 bytes where only that
    divides) along the rows of a beta-identity gate, where Nb, the
    operands' strides and pointers allow; else 1."""
    if not tab.beta_identity:
        return 1
    item = ops[0].element_size()
    vec = 16 // item
    while vec > 1 and (tab.Nb % vec or any(
            X.data_ptr() % (vec * item) or X.stride(0) % vec
            or X.stride(1) % vec for X in ops)):
        vec //= 2
    return vec


def gate_rotate(X, tab, c, s, inverse=False):
    """Rotate the gate's pairs of every grid of X (L, M, Na, Nb) in place
    by its lane's (c, s) ((L,) or (1,) tensors on X's device; the inverse
    rotation with ``inverse``); returns X.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if not _gk._on_card("gate_rotate", X):
        return gate_rotate_plain(X, tab, c, s, inverse)
    L, M = _grids("gate_rotate", X, tab)
    if X.numel() == 0:
        return X
    if L * M > _GRID_Y_MAX:
        raise ValueError(f"gate_rotate: {L} x {M} grids, at most "
                         f"{_GRID_Y_MAX}")
    cstride = _trig("gate_rotate", c, s, X, L)
    _launch("gate_rotate", X.dtype, X.data_ptr(), X.stride(0), X.stride(1),
            L, M, *tab.card, c.data_ptr(), s.data_ptr(), cstride,
            -1 if inverse else 1, _vec(tab, X), _gk._stream(X))
    return X


def _coef(name, coef, X):
    if (coef.numel() != 1 or coef.dtype != X.dtype
            or coef.device != X.device):
        raise ValueError(f"{name}: coef must be a one-element {X.dtype} "
                         f"tensor on {X.device}")


def gate_generator_add(Dst, Src, tab, coef, scale=1):
    """Dst += (scale * coef) G Src in place, Dst and Src (L, 1, Na, Nb),
    coef a one-element tensor on their device (read there: no host value),
    scale +-1; returns Dst.  CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if not _gk._on_card("gate_generator_add", Dst):
        return gate_generator_add_plain(Dst, Src, tab, coef, scale)
    L, _ = _grids("gate_generator_add", Dst, tab, per_lane=1)
    _grids("gate_generator_add", Src, tab, Dst.dtype, L, 1)
    _coef("gate_generator_add", coef, Dst)
    if L == 0:
        return Dst
    _launch("gate_generator_add", Dst.dtype, Dst.data_ptr(), Dst.stride(0),
            Src.data_ptr(), Src.stride(0), L, *tab.card, coef.data_ptr(),
            -1 if scale < 0 else 1, _vec(tab, Dst, Src), _gk._stream(Dst))
    return Dst


def gate_adjoint_step(P, Q, D, E, tab, c, s, out=None, h=0.0, ti=-1,
                      coef=None, scale=-1, part=None):
    """One reverse-sweep step of gate ``tab`` in place: P and E (L, 1, Na,
    Nb), D and Q (L, nt, Na, Nb) (D and E both None, or both given).

    With ``out`` (a (L, nt) view), out[lane, t] += h * (<Q_t, G P> + <E,
    G D_t>) at the given (post-gate) operands; then every operand takes
    the inverse rotation of its lane's (c, s); then, for ti >= 0, D_ti +=
    (scale * coef) G P and Q_ti += (scale * coef) G E at the rotated P and
    E, coef a one-element tensor read on the device.  ``part`` is scratch
    for L * nt * ka partial sums (allocated here when None).  Returns out.
    CPU tensors take the plain version; CUDA tensors the kernel, which sums
    the dot products in a fixed order (the same bits on every launch)."""
    if not _gk._on_card("gate_adjoint_step", P):
        return gate_adjoint_step_plain(P, Q, D, E, tab, c, s, out, h, ti,
                                       coef, scale)
    name = "gate_adjoint_step"
    L, _ = _grids(name, P, tab, per_lane=1)
    _, nt = _grids(name, Q, tab, P.dtype, L)
    if (D is None) != (E is None):
        raise ValueError(f"{name}: D and E go together")
    if D is not None:
        _grids(name, D, tab, P.dtype, L, nt)
        _grids(name, E, tab, P.dtype, L, 1)
    if ti >= 0:
        if D is None or ti >= nt:
            raise ValueError(f"{name}: generator tangent {ti} needs D and E "
                             f"and nt > {ti}")
        _coef(name, coef, P)
    if L == 0:
        return out
    if L > _GRID_Y_MAX:
        raise ValueError(f"{name}: {L} lanes, at most {_GRID_Y_MAX}")
    cstride = _trig(name, c, s, P, L)
    outp, ol, ot = None, 0, 0
    if out is not None:
        if (out.dtype != P.dtype or out.device != P.device
                or tuple(out.shape) != (L, nt)):
            raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} "
                             f"must be a ({L}, {nt}) {P.dtype} view on "
                             f"{P.device}")
        need = L * nt * tab.ka
        if part is None:
            part = P.new_empty(need)
        elif (part.numel() < need or part.dtype != P.dtype
              or part.device != P.device):
            raise ValueError(f"{name}: part holds {part.numel()} "
                             f"{part.dtype}, needs {need} {P.dtype}")
        outp, ol, ot = out.data_ptr(), out.stride(0), out.stride(1)
    ops = [X for X in (P, Q, D, E) if X is not None]
    _launch(name, P.dtype, P.data_ptr(), P.stride(0),
            E.data_ptr() if E is not None else None,
            E.stride(0) if E is not None else 0,
            D.data_ptr() if D is not None else None,
            D.stride(0) if D is not None else 0,
            D.stride(1) if D is not None else 0,
            Q.data_ptr(), Q.stride(0), Q.stride(1), L, nt, *tab.card,
            c.data_ptr(), s.data_ptr(), cstride,
            part.data_ptr() if outp is not None else None, outp, ol, ot,
            float(h), int(ti), coef.data_ptr() if ti >= 0 else None,
            -1 if scale < 0 else 1, _vec(tab, *ops), _gk._stream(P))
    return out
