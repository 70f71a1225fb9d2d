"""The JAX package's identity-keyed memos, cleared around each parity test.

Three memos of the JAX package are keyed on ``id(gm.srcA)``, the Python
identity of a maps object's array, and hold no reference to the maps:

* ``auto_oo_tpu.ops.grid._INV_ALPHA_CACHE`` (``inverse_alpha_maps``);
* ``auto_oo_tpu.ops.grid._ROW_SCAN_CACHE`` (``_row_scan_tables``, under
  the streamed ``rdms_rows``, ``ham_apply_rows``, ``transition_rdms_rows``
  and the hosted passes);
* ``auto_oo_tpu.ops.grid_hosted._CHUNKED_INV_CACHE``
  (``_chunked_inverse_tables``, under the hosted H-apply).

Once a ``GridMaps`` dies, the next one can take its ``srcA``'s id, and
the memo then returns the dead maps' tables: the wrong shape where the
sectors differ in Na, the wrong content where they do not ((5,(2,2)) and
(5,(3,2)) both have Na = 10).  Under ``--dist loadfile`` a worker runs
many files in one process, so a port test that holds the port against
these functions would pass or fail by which files ran before it.

A port test module that reaches these memos, directly or through a JAX
``OO_pqc`` on its streamed or hosted route, is named in ``AFFECTED`` and
imports both fixtures below.  They are autouse: ``fresh_jax_memos_module``
clears the three memos before the module's own module-scoped fixtures
(autouse fixtures come first within a scope) and after its last test, and
``fresh_jax_memos`` before and after each test, so the reference computes
its value for the maps in hand.  A fixture that builds several JAX maps
in turn keeps each alive until it returns, so that no id is reused inside
it.  ``tests/test_torch_hosted.py::test_memo_fixtures_in_affected_module``
holds every module of ``AFFECTED`` to both imports.  Only the reference's
memos are cleared; the port keeps its own on each maps object
(``GridMaps._cache``), untouched here, so a staleness fault of the port
would still show.

``tests/torch_jax_memos_prime.py`` leaves the memos filled by dead maps,
as the files before a test file on a worker can; run first in one
process, outside xdist, it checks a file for order independence (README,
"The PyTorch port").
"""

import pytest

from auto_oo_tpu.ops import grid as _jgrid
from auto_oo_tpu.ops import grid_hosted as _jgh

# the port test modules that write the memos (each run alone with a
# recorder of the three dicts' writes; the other test_torch_* files
# write none)
AFFECTED = ("test_torch_gradient", "test_torch_gram", "test_torch_hosted",
            "test_torch_mixed", "test_torch_row_sharded",
            "test_torch_streamed")


def clear_jax_memos():
    """Empty the JAX package's three id-keyed memos (named directly, so a
    rename in the JAX package fails here rather than passing silently)."""
    _jgrid._INV_ALPHA_CACHE.clear()
    _jgrid._ROW_SCAN_CACHE.clear()
    _jgh._CHUNKED_INV_CACHE.clear()


@pytest.fixture(autouse=True)
def fresh_jax_memos():
    """Clear the JAX package's id-keyed memos around each test."""
    clear_jax_memos()
    yield
    clear_jax_memos()


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_memos_module():
    """Clear the JAX package's id-keyed memos around each module, before
    its module-scoped fixtures compute their JAX references."""
    clear_jax_memos()
    yield
    clear_jax_memos()
