"""Device milliseconds per iteration in the Newton core's grad_hess, between
the CUDA events of its ``oo/core:grad_hess`` span (no synchronize)."""

from benchmark import layers


def read(run):
    return layers.dev_ms(run, "newton",
                         lambda name: name == "oo/core:grad_hess")
