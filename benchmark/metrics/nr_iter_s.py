"""Window seconds over the damped-Newton iterations completed in it."""

from benchmark import readers


def read(run):
    return readers.per_step(run, "newton")
