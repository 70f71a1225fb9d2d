"""The gradient steps' share of the f64 peak: the frozen count of a step
over the profiled stretch times 67 TFLOP/s."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "adam")
