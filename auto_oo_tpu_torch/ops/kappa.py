"""Orbital-rotation parameter (kappa) packing and index maps.

Port of auto_oo_tpu/ops/kappa.py (reference oo_energy.py:63-118).
"""

import numpy as np
import torch

from ..utils.misc import index_tensor


def _tril(size, device):
    """(rows, cols) of np.tril_indices(size, k=-1) on ``device``."""
    rows, cols = np.tril_indices(size, k=-1)
    return index_tensor(rows, device), index_tensor(cols, device)


def vector_to_skew_symmetric(vector, size=None):
    """Map a packed lower-triangle vector to a skew-symmetric matrix.

    Same layout as the reference (np.tril_indices order, reference
    oo_energy.py:63-87): e.g. [1..6] ->
    [[0,-1,-2,-4],[1,0,-3,-5],[2,3,0,-6],[4,5,6,0]].
    """
    if size is None:
        size = int(np.sqrt(8 * vector.shape[-1] + 1) + 1) // 2
    rows, cols = _tril(size, vector.device)
    if vector.dim() > 1:
        # leading batch dims (one vector per geometry or trial): the
        # same two writes on the flattened last two axes
        flat = vector.new_zeros(vector.shape[:-1] + (size * size,))
        flat = flat.index_copy(-1, rows * size + cols, vector).index_copy(
            -1, cols * size + rows, -vector)
        return flat.reshape(vector.shape[:-1] + (size, size))
    # out of place, so torch.func transforms (grad, hessian) trace it
    mat = torch.zeros((size, size), dtype=vector.dtype, device=vector.device)
    return mat.index_put((rows, cols), vector).index_put((cols, rows),
                                                         -vector)


def skew_symmetric_to_vector(kappa_matrix):
    """Inverse of vector_to_skew_symmetric (lower triangle, tril order);
    leading batch dims are kept."""
    rows, cols = _tril(kappa_matrix.shape[-1], kappa_matrix.device)
    return kappa_matrix[..., rows, cols]


def non_redundant_indices(occ_idx, act_idx, virt_idx, freeze_active=False):
    """Positions (into the full tril packing) of non-redundant orbital
    rotations: occ-act, act-virt, occ-virt and, unless frozen, act-act
    (reference oo_energy.py:97-118).  Host-side numpy; static per problem.
    """
    occ_idx = list(np.asarray(occ_idx).ravel())
    act_idx = list(np.asarray(act_idx).ravel())
    virt_idx = list(np.asarray(virt_idx).ravel())
    no, na, nv = len(occ_idx), len(act_idx), len(virt_idx)
    nao = no + na + nv
    rotation_sizes = [no * na, na * nv, no * nv]
    if not freeze_active:
        rotation_sizes.append(na * (na - 1) // 2)
    n_kappa = sum(rotation_sizes)
    occ_s, act_s, virt_s = set(occ_idx), set(act_idx), set(virt_idx)
    params_idx = []
    for num, (l_idx, r_idx) in enumerate(zip(*np.tril_indices(nao, -1))):
        if ((l_idx in act_s and r_idx in act_s) and freeze_active):
            continue
        if (l_idx in occ_s and r_idx in occ_s):
            continue
        if (l_idx in virt_s and r_idx in virt_s):
            continue
        params_idx.append(num)
    params_idx = np.array(params_idx, dtype=int)
    if n_kappa != len(params_idx):
        raise AssertionError("non-redundant rotation count mismatch")
    return params_idx
