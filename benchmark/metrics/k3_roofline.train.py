"""K3 (backward compositing): % of its bound."""

from benchmark import readers


def read(trace, cell):
    return readers.roofline(trace, "train", "k3")
