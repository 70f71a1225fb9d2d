"""The check catches a broken program: each fault planted underneath the
timed path of a tiny run on the CPU makes ``correct`` come out false,
and the control (the reference in float32 in the program's place) fails
the cells' limits.

The faults a cell of this benchmark can have: a step that returns its
state unchanged, and an energy altered where it is produced.  A step
takes one molecule and one state (no batch to halve) on one card (no
exchange between cards)."""

import pytest

from auto_oo_tpu_torch import config
from auto_oo_tpu_torch.models import oo_pqc
from auto_oo_tpu_torch.utils import optim

from benchmark import control, harness

import tiny


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    previous = config.get_device()
    config.set_device("cpu")
    yield tiny.make_root(str(tmp_path_factory.mktemp("faults")))
    config.set_device(previous)


def _run(tiny_root, cell):
    root, path = tiny_root
    return harness.run_cell(cell, 2 ** 31 + 5, 0.5, False, "cpu",
                            root=root, manifest=path)


def test_sound_runs_are_correct(tiny_root):
    for cell in ("tiny-nr", "tiny-adam"):
        assert _run(tiny_root, cell)["correct"] is True


def test_newton_step_returning_its_state_unchanged(tiny_root, monkeypatch):
    orig = oo_pqc.OO_pqc._nr_iteration

    def unchanged(self, theta, oao, *args):
        return (theta,) + tuple(orig(self, theta, oao, *args)[1:])

    monkeypatch.setattr(oo_pqc.OO_pqc, "_nr_iteration", unchanged)
    result = _run(tiny_root, "tiny-nr")
    assert result["correct"] is False
    assert result["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_adam_step_returning_its_state_unchanged(tiny_root, monkeypatch):
    monkeypatch.setattr(optim, "apply_updates", lambda params, upd: params)
    result = _run(tiny_root, "tiny-adam")
    assert result["correct"] is False
    assert result["checks"]["step_gap"]["value"] == pytest.approx(1.0)


def test_newton_energy_altered_where_produced(tiny_root, monkeypatch):
    orig = oo_pqc.OO_pqc._nr_iteration

    def altered(self, theta, oao, *args):
        out = list(orig(self, theta, oao, *args))
        out[3] = out[3] + 1e-7
        return tuple(out)

    monkeypatch.setattr(oo_pqc.OO_pqc, "_nr_iteration", altered)
    result = _run(tiny_root, "tiny-nr")
    assert result["correct"] is False
    assert result["checks"]["energy_gap"]["value"] > 5e-8


def test_gradient_energy_altered_where_produced(tiny_root, monkeypatch):
    orig = oo_pqc.OO_pqc.energy_and_gradient

    def altered(self, theta):
        e, grad, rdms = orig(self, theta)
        return e + 1e-7, grad, rdms

    monkeypatch.setattr(oo_pqc.OO_pqc, "energy_and_gradient", altered)
    result = _run(tiny_root, "tiny-adam")
    assert result["correct"] is False
    assert result["checks"]["energy_gap"]["value"] > 5e-8


@pytest.mark.parametrize("cell", ["tiny-nr", "tiny-adam"])
def test_the_control_is_not_correct(tiny_root, cell):
    root, path = tiny_root
    c = harness.Cell(cell, root, path)
    for seed in (1, 2, 3):
        values = control.readings(c, seed, "cpu")
        correct, _ = harness.verdict(values, c.limits)
        assert not correct, values
