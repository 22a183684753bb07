"""K1 (forward compositing) in training: % of its bound."""

from benchmark import readers


def read(trace, cell):
    return readers.roofline(trace, "train", "k1")
