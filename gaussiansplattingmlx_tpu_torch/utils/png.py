"""PNG writer on the standard library alone (zlib + struct): the card's
machine has neither Pillow nor matplotlib.  Used by the render CLI and by
the trainer's previews."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (grey) or [H, W, 3] (RGB) image as PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))
