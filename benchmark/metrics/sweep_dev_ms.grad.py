"""Device milliseconds per gradient step in the simulator's sweeps: the
outermost ``oo/sim:*`` spans, between their CUDA events."""

from benchmark import layers


def read(run):
    return layers.dev_ms(run, "adam",
                         lambda name: name.startswith("oo/sim:"))
