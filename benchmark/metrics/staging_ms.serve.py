"""Device ms a served frame in staging: sorts, scans, K2 / K5."""

from benchmark import readers


def read(trace, cell):
    return readers.group_ms(trace, "serve", "staging")
