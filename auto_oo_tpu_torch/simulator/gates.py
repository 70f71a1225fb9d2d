"""Host-side gate compilation: every ansatz gate -> paired Givens rotations.

Numpy copy of auto_oo_tpu/simulator/gates.py.  Instead of a gate-by-gate
simulator (PennyLane default.qubit in the reference, pqc.py:133), each
gate used by the UCC / GateFabric / k-UpCCD ansatz families is an
orthogonal rotation that pairs up computational-basis states, with a
sign from Jordan-Wigner parities and an angle multiplier:

    psi[ia] <- cos(h)  psi[ia] - sgn sin(h) psi[ib]
    psi[ib] <- sgn sin(h) psi[ia] + cos(h) psi[ib],  h = half * theta

The port uses the bit-mask helpers here through simulator/grid_gates.py.

Conventions: big-endian qubit order (qubit 0 = MSB), interleaved spins —
see ops/fermion.py.
"""

import numpy as np

from ..ops import fermion


class PairGate:
    """(ia, ib, sign) pairs + angle multiplier + parameter slot.

    `name`/`wires` are display metadata for circuit drawing; they do not
    affect simulation."""

    __slots__ = ("ia", "ib", "sign", "half", "param", "name", "wires")

    def __init__(self, ia, ib, sign, half, param, name=None, wires=None):
        self.ia = np.asarray(ia, dtype=np.int32)
        self.ib = np.asarray(ib, dtype=np.int32)
        self.sign = np.asarray(sign, dtype=np.float64)
        self.half = float(half)
        self.param = int(param)
        self.name = name
        self.wires = tuple(wires) if wires is not None else None


def _bit(nm, mode):
    return 1 << (nm - 1 - mode)


def _parity(dets, mask):
    """(-1)^{popcount(dets & mask)} as +-1 float."""
    return (1.0 - 2.0 * (fermion.popcount(dets & mask) & 1)).astype(
        np.float64)


def _mask_below(nm, mode):
    """Bit mask of modes strictly below `mode` (JW string)."""
    m = 0
    for k in range(mode):
        m |= _bit(nm, k)
    return m


def fermionic_double_pairs(p, q, r, s, nm, param, half=1.0, sign_flip=1.0,
                           dets=None):
    """exp(theta (T - T^dag)), T = a^dag_p a^dag_q a_r a_s (JW-exact).

    Matches qml.FermionicDoubleExcitation with wires1=[s..r], wires2=[q..p]
    (reference ansatze/uccd.py:109-113); sign convention calibrated against
    the reference golden statevectors (tests/test_pqc.py).

    `dets` optionally restricts the determinant universe (e.g. a particle
    sector basis): pairs are built only among those determinants, and the
    returned (ia, ib) hold determinant VALUES (callers rank-remap them) —
    this keeps sector-program construction O(D_sector), never touching the
    4^ncas space.
    """
    dets = (np.arange(1 << nm, dtype=np.int64) if dets is None
            else np.asarray(dets, dtype=np.int64))
    bp, bq, br, bs = (_bit(nm, m) for m in (p, q, r, s))
    src_mask = ((dets & br != 0) & (dets & bs != 0)
                & (dets & bp == 0) & (dets & bq == 0))
    src = dets[src_mask]
    # apply a_s, a_r, a^dag_q, a^dag_p tracking JW parities
    sgn = _parity(src, _mask_below(nm, s))
    cur = src ^ bs
    sgn = sgn * _parity(cur, _mask_below(nm, r))
    cur = cur ^ br
    sgn = sgn * _parity(cur, _mask_below(nm, q))
    cur = cur ^ bq
    sgn = sgn * _parity(cur, _mask_below(nm, p))
    dst = cur ^ bp
    return PairGate(src, dst, sign_flip * sgn, half, param,
                    name='FermionicDouble', wires=(p, q, r, s))


def fermionic_single_pairs(p, r, nm, param, half=1.0, sign_flip=1.0,
                           dets=None):
    """exp(theta (T - T^dag)), T = a^dag_p a_r (JW-exact,
    qml.FermionicSingleExcitation semantics).  `dets` as in
    fermionic_double_pairs."""
    dets = (np.arange(1 << nm, dtype=np.int64) if dets is None
            else np.asarray(dets, dtype=np.int64))
    bp, br = _bit(nm, p), _bit(nm, r)
    src_mask = (dets & br != 0) & (dets & bp == 0)
    src = dets[src_mask]
    sgn = _parity(src, _mask_below(nm, r))
    cur = src ^ br
    sgn = sgn * _parity(cur, _mask_below(nm, p))
    dst = cur ^ bp
    return PairGate(src, dst, sign_flip * sgn, half, param,
                    name='FermionicSingle', wires=(p, r))


def double_excitation_pairs(wires, nm, param, sign_flip=1.0, dets=None):
    """qml.DoubleExcitation(phi): Givens rotation by phi/2 between the
    |0011> and |1100> patterns of four wires (no JW string — it is defined
    as a qubit gate).  `dets` as in fermionic_double_pairs."""
    w0, w1, w2, w3 = wires
    dets = (np.arange(1 << nm, dtype=np.int64) if dets is None
            else np.asarray(dets, dtype=np.int64))
    b0, b1, b2, b3 = (_bit(nm, w) for w in (w0, w1, w2, w3))
    # ia: |0011> pattern (w2, w3 occupied), ib: |1100>
    ia_mask = ((dets & b0 == 0) & (dets & b1 == 0)
               & (dets & b2 != 0) & (dets & b3 != 0))
    ia = dets[ia_mask]
    ib = ia ^ b0 ^ b1 ^ b2 ^ b3
    sgn = np.full(ia.shape, sign_flip)
    return PairGate(ia, ib, sgn, 0.5, param,
                    name='DoubleExcitation', wires=(w0, w1, w2, w3))


def single_excitation_pairs(wires, nm, param, half=0.5, sign_flip=1.0,
                            string_mask=0, dets=None):
    """qml.SingleExcitation(phi)-style Givens between |01> and |10> of two
    wires; optional JW string parity via `string_mask` (used by
    OrbitalRotation's fermionic variant).  `dets` as in
    fermionic_double_pairs."""
    w0, w1 = wires
    dets = (np.arange(1 << nm, dtype=np.int64) if dets is None
            else np.asarray(dets, dtype=np.int64))
    b0, b1 = _bit(nm, w0), _bit(nm, w1)
    ia_mask = (dets & b0 == 0) & (dets & b1 != 0)  # |01>
    ia = dets[ia_mask]
    ib = ia ^ b0 ^ b1
    sgn = np.full(ia.shape, sign_flip)
    if string_mask:
        sgn = sgn * _parity(ia, string_mask)
    return PairGate(ia, ib, sgn, half, param,
                    name='SingleExcitation', wires=(w0, w1))


def orbital_rotation_pairs(wires, nm, param, sign_flip=1.0,
                           with_string=True, dets=None):
    """qml.OrbitalRotation(phi) on four wires (w0,w1 = spatial orbital 1
    up/down, w2,w3 = spatial orbital 2 up/down): two commuting spin
    rotations between (w0,w2) and (w1,w3).  `with_string` includes the JW
    parity of the crossed intermediate wire (the fermionic definition).
    Returns a list of PairGate sharing one parameter."""
    w0, w1, w2, w3 = wires
    sm_a = _bit(nm, w1) if with_string else 0
    sm_b = _bit(nm, w2) if with_string else 0
    g_a = single_excitation_pairs((w0, w2), nm, param, half=0.5,
                                  sign_flip=sign_flip, string_mask=sm_a,
                                  dets=dets)
    g_b = single_excitation_pairs((w1, w3), nm, param, half=0.5,
                                  sign_flip=sign_flip, string_mask=sm_b,
                                  dets=dets)
    g_a.name = g_b.name = 'OrbitalRotation'
    g_a.wires = g_b.wires = (w0, w1, w2, w3)
    return [g_a, g_b]
