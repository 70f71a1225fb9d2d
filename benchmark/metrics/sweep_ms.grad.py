"""Milliseconds per gradient step in the simulator's sweeps: the state
sweep and the adjoint gradient sweep."""

from benchmark import readers


def read(run):
    return readers.parts_ms(run, "adam", readers.SWEEPS)
