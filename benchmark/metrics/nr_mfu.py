"""The damped-Newton iterations' share of the f64 peak: the frozen count
of each iteration with the Armijo trials it ran, over the profiled
stretch times 67 TFLOP/s."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "newton")
