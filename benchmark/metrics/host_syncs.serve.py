"""Synchronising CUDA calls a served frame."""

from benchmark import readers


def read(trace, cell):
    return readers.host_syncs(trace, "serve")
