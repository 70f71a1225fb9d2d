"""The frozen counts against the program's own functions (CPU)."""

import importlib.util
import os
from math import comb

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import auto_oo_tpu_torch as P
from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.ops import grid, grid_kernels
from auto_oo_tpu_torch.utils import flops as F

from benchmark import counts, harness
from benchmark.reference import chem


@pytest.fixture(scope="module", autouse=True)
def on_cpu():
    previous = config.get_device()
    config.set_device("cpu")
    yield
    config.set_device(previous)


def cell_shapes(ncas):
    """(ncas, D, n_theta, n_kappa, nao, ns, pairs) of the chain cells."""
    D = comb(ncas, ncas // 2) ** 2
    return (ncas, D, 14, 0, ncas, ncas, counts.pairs_per_apply(ncas, 1))


@pytest.mark.parametrize("ncas", [4, 6, 8, 10])
def test_pairs_per_apply_equal_the_port(ncas):
    pqc = P.Parameterized_circuit(ncas, ncas, ansatz="np_fabric",
                                  n_layers=1, sector=True)
    assert counts.pairs_per_apply(ncas, 1) == F._pairs_of(pqc)


@pytest.mark.parametrize("ncas", [14, 16])
@pytest.mark.parametrize("trials", [1, 4, 20])
def test_newton_count_equals_the_port_at_the_cells(ncas, trials):
    shapes = cell_shapes(ncas)
    port = (F.grad_hess_flops(*shapes)
            + F.update_flops(*shapes, newton_method=None, n_trials=trials))
    assert counts.nr_iteration_flops(shapes, trials) == port
    assert counts.grad_hess_flops(*shapes) == F.grad_hess_flops(*shapes)


def test_config_files_state_the_cells_shapes():
    for name, ncas in (("h14_chain_sto3g_npfabric1", 14),
                       ("h16_chain_sto3g_npfabric1", 16)):
        cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                             name + ".json"))
        assert (cfg["ncas"], cfg["nelecas"], cfg["atoms"]) == (ncas,) * 3
        assert cfg["n_theta"] == cell_shapes(ncas)[2]


@pytest.mark.parametrize("t,beta", [(1.0, 0.5), (0.125, 0.5), (0.0, 0.5),
                                    (0.25, 0.5), (0.3, 0.3)])
def test_armijo_trials_equal_the_port(t, beta):
    assert counts.armijo_trials(t, beta) == F.armijo_trials(t, beta)


def test_grad_step_count_against_the_flop_counter():
    """The matrix products of one gradient step, as torch counts them, at
    (8e,8o): the count adds the gathers and sweeps the counter does not
    see, so it lies a little above."""
    geo = chem.chain_geometry(8, 0.9)
    mol = P.Moldata(geo, "sto-3g")
    pqc = P.Parameterized_circuit(8, 8, ansatz="np_fabric", n_layers=1,
                                  sector=True)
    oo = P.OO_pqc(pqc, mol, 8, 8, freeze_active=True)
    theta = torch.full((pqc.theta_shape,), 0.1, dtype=torch.float64)
    oo.energy_and_gradient(theta)
    with FlopCounterMode(display=False) as fc:
        oo.energy_and_gradient(theta)
    shapes = (8, pqc.state_dim, pqc.theta_shape, 0, 8, 8,
              counts.pairs_per_apply(8, 1))
    ratio = counts.grad_step_flops(shapes) / fc.get_total_flops()
    assert 1.0 <= ratio <= 1.2, ratio


@pytest.mark.parametrize("ncas,windows", [(6, [(0, 20), (3, 11)]),
                                          (8, [(0, 70), (10, 45)])])
def test_two_spin_bytes_equal_the_port(ncas, windows):
    gm = grid.build_grid_maps(ncas, ncas, device="cpu")
    tables = gm.two_spin_tables()
    for itemsize, dtype in ((8, torch.float64), (4, torch.float32)):
        x = torch.zeros((gm.Na, gm.Nb), dtype=dtype)
        for r0, r1 in windows:
            assert counts.two_spin_bytes(x.shape, itemsize, tables, r0,
                                         r1) == grid_kernels.two_spin_bytes(
                x, tables, r0, r1).bound


def _chip_smoke():
    path = os.path.join(os.path.dirname(harness.HERE), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scatter_bytes_equal_chip_smoke():
    smoke = _chip_smoke()
    gm = grid.build_grid_maps(8, 8, device="cpu")
    n2 = 64
    for rows, r0 in ((20, 0), (15, 40)):
        Y = torch.zeros((n2, rows, gm.Nb), dtype=torch.float64)
        assert counts.scatter_bytes(
            Y.shape, 8, gm.srcA, gm.sgnA, gm.tB, r0) == smoke.scatter_bytes(
            Y, gm.srcA, gm.sgnA, gm.tB, r0)


def test_peaks_equal_the_port():
    assert counts.FP64_PEAK == F.FP64_PEAK
    assert counts.HBM_BYTES_PER_S == F.HBM_BYTES_PER_S
    assert counts.EIGH_FLOPS_PER_N3 == F.EIGH_FLOPS_PER_N3
    assert np.isfinite(counts.grad_step_flops(cell_shapes(16)))
