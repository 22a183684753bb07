"""K1 (forward compositing) in serving: % of its bound."""

from benchmark import readers


def read(trace, cell):
    return readers.roofline(trace, "serve", "k1")
