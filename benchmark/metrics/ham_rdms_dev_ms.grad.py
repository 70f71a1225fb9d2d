"""Device milliseconds per gradient step in the H-apply and RDM passes:
the outermost ``oo/ham:*`` spans, between their CUDA events."""

from benchmark import layers


def read(run):
    return layers.dev_ms(run, "adam",
                         lambda name: name.startswith("oo/ham:"))
