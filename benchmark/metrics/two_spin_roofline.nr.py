"""gather_two_spin's share of its bandwidth bound in the Newton cells."""

from benchmark import readers


def read(run):
    return readers.roofline(run, "newton", "gather_two_spin")
