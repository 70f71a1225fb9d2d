"""Milliseconds per gradient step in which the device idles while the
innermost span open on the host is an ``oo/loop:*`` span: the step's own
work (the energy read, the Adam update, the monitor)."""

from benchmark import layers


def read(run):
    return layers.idle_ms(run, "adam", "loop")
