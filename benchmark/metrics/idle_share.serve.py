"""Idle share of the device in a traced window of served frames (%)."""

from benchmark import readers


def read(trace, cell):
    return readers.idle_share(trace, "serve")
