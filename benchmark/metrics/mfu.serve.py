"""The whole served frame's share of the card's float32 peak (%)."""

from benchmark import readers


def read(trace, cell):
    return readers.mfu(trace, "serve")
