"""Milliseconds per gradient step in the H psi and RDM parts of the
gradient-only pass (streamed: "H psi" and "RDMs"; hosted: the fused
pass)."""

from benchmark import readers


def read(run):
    return readers.parts_ms(run, "adam", readers.HAM_RDMS)
