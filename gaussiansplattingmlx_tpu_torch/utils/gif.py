"""Animated GIF writer on numpy and the standard library (render_cli's
``--video``; the port does not use Pillow).  Colours are quantised to a
fixed 6 x 7 x 6 palette, and the image data is LZW-coded as literals only,
with a clear code before the code width would grow past 9 bits: larger
than an adaptive encoder's output, but plain, and read by every decoder."""

from __future__ import annotations

import struct

import numpy as np

_LEVELS = (6, 7, 6)  # red, green, blue
# Literals between clear codes: the decoder's table then stays below 512
# entries, so every code is 9 bits wide.
_RUN = 250


def _palette() -> np.ndarray:
    r, g, b = (np.rint(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS)
    table = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    out = np.zeros((256, 3), np.uint8)
    out[:len(table)] = table
    return out


def _quantise(frame: np.ndarray) -> np.ndarray:
    q = [np.rint(frame[..., c].astype(np.float64) * (n - 1) / 255.0).astype(np.int64)
         for c, n in enumerate(_LEVELS)]
    return ((q[0] * _LEVELS[1] + q[1]) * _LEVELS[2] + q[2]).ravel()


def _lzw_literals(indices: np.ndarray) -> bytes:
    """9-bit codes, least significant bit first: clear (256), up to _RUN
    literals, clear, ..., end of information (257)."""
    n = indices.size
    runs = -(-n // _RUN)
    codes = np.full(n + runs + 1, 256, np.int64)
    pos = np.arange(n) + np.arange(n) // _RUN + 1  # after each run's clear code
    codes[pos] = indices
    codes[-1] = 257
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    return np.packbits(bits, bitorder="little").tobytes()


def write_gif(path, frames, duration_ms: int) -> None:
    """Write uint8 [H, W, 3] frames as a GIF that loops forever, each shown
    for ``duration_ms`` (rounded to GIF's 10 ms unit)."""
    h, w = frames[0].shape[:2]
    delay = max(1, round(duration_ms / 10))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in frames:
        data = _lzw_literals(_quantise(np.asarray(frame, np.uint8)))
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0))
        out.append(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0) + b"\x08")
        out.extend(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                   for i in range(0, len(data), 255))
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
