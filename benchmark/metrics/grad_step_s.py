"""Window seconds over the Adam steps completed in it."""

from benchmark import readers


def read(run):
    return readers.per_step(run, "adam")
