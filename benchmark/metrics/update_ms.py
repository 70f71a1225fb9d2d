"""Milliseconds of an iteration outside the Newton core's grad_hess parts:
the eigh solve, the Armijo trials' energies, the MO fold and the loop."""

from benchmark import readers


def read(run):
    return readers.update_ms(run)
