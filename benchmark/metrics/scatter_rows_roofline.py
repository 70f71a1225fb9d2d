"""scatter_rows' share of its bandwidth bound (the hosted route)."""

from benchmark import readers


def read(run):
    return readers.roofline(run, None, "scatter_rows")
