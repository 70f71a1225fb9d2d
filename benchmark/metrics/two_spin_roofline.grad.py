"""gather_two_spin's share of its bandwidth bound in the gradient cells."""

from benchmark import readers


def read(run):
    return readers.roofline(run, "adam", "gather_two_spin")
