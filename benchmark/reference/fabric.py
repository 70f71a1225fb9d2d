"""The number-preserving gate fabric on the determinant grid, plain PyTorch.

The fabric of Anselmetti et al., New J. Phys. 23, 113010 (2021), as
PennyLane's ``GateFabric`` (``include_pi=False``) lays it out on 2n
qubits, spin orbitals interleaved (qubit 2p is orbital p alpha, 2p + 1
orbital p beta): each layer holds the four-qubit blocks on qubits 4b..4b+3
(orbitals 2b, 2b+1), then those on 4b+2..4b+5 (orbitals 2b+1, 2b+2).  A
block on orbitals (p, p+1) applies DoubleExcitation(theta), then
OrbitalRotation(phi).  As fermionic operators (the Jordan-Wigner strings
inside a block of adjacent qubits fixed; those outside cancel):

    DoubleExcitation(theta) = exp(-theta/2 (T - T+)),
        T = a+_{p+1,a} a+_{p+1,b} a_{p,b} a_{p,a} = E^a_{p+1,p} E^b_{p+1,p}
    OrbitalRotation(phi)    = exp(-phi/2 (E_{p+1,p} - E_{p,p+1}))

so on the grid each is a Givens rotation between the strings with p
filled and p+1 empty (set A) and their partners (set B), with sign +1
(no orbital lies between p and p+1): on the rows and on the columns for
the orbital rotation, on the (A, A) and (B, B) sub-grids for the double
excitation.  From the Hartree-Fock determinant the first layer's
offset-0 blocks that lie wholly in the filled or wholly in the empty
orbitals act as the identity; their angles are fixed at 0 and left out
of theta (the reference package's rule at half filling), and theta lists
the other angles in the layout's order.
"""

import math

import torch


class Fabric:
    """The fabric of ``n_layers`` layers on a ``fci.Space``: ``gates`` is
    (kind, p) of each angle of theta in order, kind "de" or "or"."""

    def __init__(self, space, n_layers):
        n, ne = space.n, space.ne
        if n % 2 or ne * 2 != n:
            raise ValueError("the fabric's redundant angles are those of a "
                             "half-filled active space of even size")
        self.space = space
        nq = 2 * n
        blocks = ([2 * b for b in range(nq // 4)]
                  + [2 * b + 1 for b in range((nq - 2) // 4)])
        self.gates = []
        for layer in range(n_layers):
            for i, p in enumerate(blocks):
                qubits = range(2 * p, 2 * p + 4)
                idle = (layer == 0 and i < nq // 4
                        and (all(q < 2 * ne for q in qubits)
                             or all(q >= 2 * ne for q in qubits)))
                if not idle:
                    self.gates += [("de", p), ("or", p)]
        tab = space.strings
        self.sets = {}
        for _, p in self.gates:
            a = ((tab >> p) & 1 == 1) & ((tab >> (p + 1)) & 1 == 0)
            A = torch.as_tensor(a.nonzero()[0], device=space.device)
            B = space.tgt[(p + 1) * n + p, A]
            self.sets[p] = (A, B)

    @property
    def n_theta(self):
        return len(self.gates)

    def _mix(self, C, i, m, out=None):
        """Gate i's 2x2 map m = ((m00, m01), (m10, m11)) on its pairs:
        new_A = m00 C_A + m01 C_B, new_B = m10 C_A + m11 C_B, in place
        (out None) or into ``out`` (zero elsewhere: a generator)."""
        kind, p = self.gates[i]
        A, B = self.sets[p]
        dst = C if out is None else out
        if kind == "de":
            cA, cB = C[A[:, None], A], C[B[:, None], B]
            dst[A[:, None], A] = m[0][0] * cA + m[0][1] * cB
            dst[B[:, None], B] = m[1][0] * cA + m[1][1] * cB
            return dst
        cA, cB = C[A], C[B]
        if out is not None:
            # the generator of a product of commuting row and column
            # rotations is the sum of the two generators
            dst[A] += m[0][0] * cA + m[0][1] * cB
            dst[B] += m[1][0] * cA + m[1][1] * cB
            cA, cB = C[:, A], C[:, B]
            dst[:, A] += m[0][0] * cA + m[0][1] * cB
            dst[:, B] += m[1][0] * cA + m[1][1] * cB
            return dst
        dst[A] = m[0][0] * cA + m[0][1] * cB
        dst[B] = m[1][0] * cA + m[1][1] * cB
        cA, cB = C[:, A], C[:, B]
        dst[:, A] = m[0][0] * cA + m[0][1] * cB
        dst[:, B] = m[1][0] * cA + m[1][1] * cB
        return dst

    def rotate(self, C, i, angle, inverse=False):
        """Apply gate i at ``angle`` (its transpose with ``inverse``) to C
        in place."""
        c, s = math.cos(angle / 2), math.sin(angle / 2)
        if inverse:
            s = -s
        return self._mix(C, i, ((c, s), (-s, c)))

    def generator(self, C, i):
        """-1/2 G_i C, the derivative of gate i at its angle composed
        with the gate (G_i commutes with it): G maps A to B and B to -A."""
        return self._mix(C, i, ((0.0, 0.5), (-0.5, 0.0)),
                         out=torch.zeros_like(C))

    def state(self, theta):
        C = self.space.hf()
        for i, th in enumerate(theta):
            self.rotate(C, i, float(th))
        return C

    def gradient(self, theta, psi, w):
        """d <w, psi(theta)> / d theta for a fixed w, by one reverse sweep
        from the final state ``psi``."""
        phi, lam = psi.clone(), w.clone()
        grad = [0.0] * self.n_theta
        for i in reversed(range(self.n_theta)):
            grad[i] = float((lam * self.generator(phi, i)).sum())
            self.rotate(phi, i, float(theta[i]), inverse=True)
            self.rotate(lam, i, float(theta[i]), inverse=True)
        return torch.tensor(grad, dtype=torch.float64)

    def jacobian_and_curvature(self, theta, w):
        """(J, S): the tangents J_i = d psi / d theta_i (n_theta, N, N)
        and S_ij = <w, d2 psi / d theta_i d theta_j> for a fixed w."""
        nt = self.n_theta
        states, C = [], self.space.hf()
        for i in range(nt):
            self.rotate(C, i, float(theta[i]))
            states.append(C.clone())
        lams, lam = [None] * nt, w.clone()
        for i in reversed(range(nt)):
            lams[i] = lam.clone()
            self.rotate(lam, i, float(theta[i]), inverse=True)
        J = torch.empty((nt,) + tuple(C.shape), dtype=C.dtype,
                        device=C.device)
        S = torch.zeros((nt, nt), dtype=torch.float64)
        for i in range(nt):
            chi = self.generator(states[i], i)
            S[i, i] = float((lams[i] * self.generator(chi, i)).sum())
            for j in range(i + 1, nt):
                self.rotate(chi, j, float(theta[j]))
                S[i, j] = S[j, i] = float(
                    (lams[j] * self.generator(chi, j)).sum())
            J[i] = chi
        return J, S
