"""Share of the profiled stretch in which no operation ran on the device,
in the Newton cells."""

from benchmark import readers


def read(run):
    return readers.idle_share(run, "newton")
