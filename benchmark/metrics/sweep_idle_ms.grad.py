"""Milliseconds per gradient step in which the device idles while the
innermost span open on the host is an ``oo/sim:*`` span (the sweeps'
host work)."""

from benchmark import layers


def read(run):
    return layers.idle_ms(run, "adam", "sim")
