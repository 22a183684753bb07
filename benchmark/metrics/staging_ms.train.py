"""Device ms a training step in staging: sorts, scans, K2 / K5, K6."""

from benchmark import readers


def read(trace, cell):
    return readers.group_ms(trace, "train", "staging")
