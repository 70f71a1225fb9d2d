"""Spin embedding of restricted integral tensors.

Port of auto_oo_tpu/ops/spin_embed.py (reference utils/active_space.py:
86-108, ``restricted_to_unrestricted``): lifts spatial-orbital 1e/2e
tensors to spin-orbital tensors, interleaved (even = alpha, odd = beta)
or, for a two-index tensor, alpha-then-beta.
"""

import numpy as np
import torch

# spin-component tensor for the 4-index case: (delta_same_spin +
# cross-spin mix) / 2, i.e. (1/2)(eye4 + X (x) X pattern) (reference
# utils/active_space.py:19-26)
_eye = np.eye(2)
_X = np.array([[0.0, 1.0], [1.0, 0.0]])
_eye4d = np.einsum("ia,ib,ic,id->abcd", _eye, _eye, _eye, _eye)
_mix4d = np.einsum("ia,ib,ic,id->abcd", _eye, _X, _X, _eye)
_SPIN_COMP = (_eye4d + _mix4d) / 2.0


def restricted_to_unrestricted(tensor, alpha_then_beta=False):
    """Spin-embed a (n,n) or (n,n,n,n) restricted tensor to 2n spin
    orbitals, on the tensor's device.  NB: physicist ordering assumed for
    the two-body tensor (as in the reference)."""
    tensor = torch.as_tensor(tensor)
    s = tensor.shape
    if len(s) == 2:
        eye = torch.eye(2, dtype=tensor.dtype, device=tensor.device)
        out = torch.einsum("pq,ab->apbq" if alpha_then_beta else
                           "pq,ab->paqb", tensor, eye)
    elif len(s) == 4:
        comp = torch.as_tensor(_SPIN_COMP, dtype=tensor.dtype,
                               device=tensor.device)
        out = torch.einsum("ijkl,abcd->iajbkcld", tensor, comp)
    else:
        raise ValueError("Only 2- or 4-dimensional tensors supported.")
    return out.reshape([2 * n for n in s])
