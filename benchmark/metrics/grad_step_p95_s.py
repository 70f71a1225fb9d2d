"""95th percentile of the Adam steps' times in the window, from the
monitor's host timestamps."""

from benchmark import readers


def read(run):
    return readers.step_percentile(run, "adam", 95.0)
