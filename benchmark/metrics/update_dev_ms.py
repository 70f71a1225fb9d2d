"""Device milliseconds per iteration in the Newton update (the eigh
solve, the Armijo trials' energies, the MO fold), between the CUDA events
of its ``oo/loop:newton_update`` span."""

from benchmark import layers


def read(run):
    return layers.dev_ms(run, "newton",
                         lambda name: name == "oo/loop:newton_update")
