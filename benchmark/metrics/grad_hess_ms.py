"""Milliseconds per iteration in the Newton core's grad_hess parts (part
timer, summed per iteration)."""

from benchmark import readers


def read(run):
    return readers.parts_ms(run, "newton", None)
