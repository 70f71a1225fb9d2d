"""Miscellaneous utilities (reference utils/miscellaneous.py parity)."""

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _index_tensor(values, device):
    return torch.tensor(values, dtype=torch.int64, device=device)


def index_tensor(values, device):
    """The host indices ``values`` (1-D) as an int64 tensor on ``device``,
    made once per (values, device): indexing a card tensor with a numpy
    array uploads it at every call, and PyTorch's upload from pageable
    memory waits for the card (a synchronization)."""
    return _index_tensor(tuple(int(v) for v in np.asarray(values).ravel()),
                         torch.device(device))


def to_numpy(x):
    """A host numpy array of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def get_formal_geo(alpha, phi):
    """Formaldimine Z-matrix, the canonical test molecule
    (reference utils/miscellaneous.py:34-45)."""
    variables = [1.498047, 1.066797, 0.987109, 118.359375] + [alpha, phi]
    geom = """
                    N
                    C 1 {0}
                    H 2 {1}  1 {3}
                    H 2 {1}  1 {3} 3 180
                    H 1 {2}  2 {4} 3 {5}
                    """.format(*variables)
    return geom
