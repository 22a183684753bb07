"""Device ms a training step in PyTorch's elementwise, reduce, index and fill kernels."""

from benchmark import readers


def read(trace, cell):
    return readers.group_ms(trace, "train", "elementwise")
