"""K4 (per-Gaussian gradient reduction): % of its bound."""

from benchmark import readers


def read(trace, cell):
    return readers.roofline(trace, "train", "k4", per_step=0)
