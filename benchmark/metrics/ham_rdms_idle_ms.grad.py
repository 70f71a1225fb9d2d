"""Milliseconds per gradient step in which the device idles while the
innermost span open on the host is an ``oo/ham:*`` span (the H-apply and
RDM passes' host work leaves the card waiting)."""

from benchmark import layers


def read(run):
    return layers.idle_ms(run, "adam", "ham")
