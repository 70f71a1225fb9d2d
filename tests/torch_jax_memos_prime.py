"""Leave the JAX package's id-keyed memos filled by dead maps, as the
test files that ran earlier on a worker can (tests/torch_jax_memos.py).

Not collected by a run of ``tests/`` (its name is not ``test_*.py``).
Pass it first, by name, in one process outside xdist, to check a port
test file for order independence:

    JAX_PLATFORMS=cpu python -m pytest tests/torch_jax_memos_prime.py \\
        tests/test_torch_hosted.py -q -p no:xdist -p no:randomly
"""

import gc

from auto_oo_tpu.ops import grid as jgrid
from auto_oo_tpu.ops import grid_hosted as jgh

SECTORS = [(2, 2), (3, (2, 1)), (4, 4), (4, (3, 1)), (5, (2, 2)),
           (5, (3, 2)), (6, 6)]


def test_prime_jax_memos():
    """JAX maps of seven sectors built, their inverse, row-scan tables
    (row chunks 1-8) and chunked inverse tables taken, and dropped, 20
    times."""
    for _ in range(20):
        for nc, ne in SECTORS:
            jm = jgrid.build_grid_maps(nc, ne)
            jgrid.inverse_alpha_maps(jm)
            Na = jm.srcA.shape[1]
            for rc in range(1, 9):
                nchunk = -(-Na // rc)
                for f in (lambda: jgrid._row_scan_tables(jm, rc),
                          lambda: jgh._chunked_inverse_tables(
                              jm, rc, nchunk, nchunk * rc - Na)):
                    try:
                        f()
                    except (TypeError, ValueError):
                        pass  # a dead maps' table of another shape
            del jm
            gc.collect()
    assert jgrid._INV_ALPHA_CACHE and jgrid._ROW_SCAN_CACHE
