"""PNG reading and writing on the standard library alone (zlib + struct),
and Pillow's ``BILINEAR`` resize in numpy, so that the port needs neither
Pillow nor matplotlib.  The dataset loaders read and resize every image
here, to the bytes the JAX package's loaders get from Pillow; the render
CLI, the trainer's previews and loss curve and the eval CLI write here.

``read_png`` decodes non-interlaced PNG at 8 bits for colour types 0, 2, 4
and 6 (grey, RGB, grey + alpha, RGBA) and greyscale at 16 bits; palette,
interlaced, 16-bit colour and sub-byte PNGs raise ``ValueError``.  JPEG has
no decoder in the standard library: ``read_image`` decodes it through
Pillow where Pillow is installed and raises ``ValueError`` elsewhere.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels (8 bits a sample; type 0 also at 16).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# Pillow's fixed-point resampling of 8-bit images (libImaging/Resample.c).
_PRECISION_BITS = 32 - 8 - 2


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
        fh.write(PNG_SIGNATURE)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters.  ``rows`` is [H, stride] uint8 with the
    filter bytes removed.  A reconstructed byte depends on the byte ``bpp``
    to its left, the one above and the one above-left, so the image is
    rebuilt one anti-diagonal of pixels at a time, all rows in one numpy
    step."""
    h, stride = rows.shape
    if not filters.any():
        return rows
    w = stride // bpp
    raw = rows.reshape(h, w, bpp).astype(np.int32)
    # One row and one column of zeros above and left of the image.
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    ftype = filters.astype(np.int32)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[y][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        out[y + 1, x + 1] = (raw[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path) -> np.ndarray:
    """Decode a PNG into the array ``np.asarray(PIL.Image.open(path))``
    gives: uint8 [H, W] (grey), [H, W, 2] (grey + alpha), [H, W, 3] (RGB),
    [H, W, 4] (RGBA), or uint16 [H, W] (16-bit grey)."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type == 3:
        raise ValueError(f"{path}: palette PNG (colour type 3) is not supported")
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color_type} is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth == 16 and color_type != 0:
        raise ValueError(f"{path}: 16-bit colour PNG (colour type {color_type}) "
                         f"is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported")
    channels = _CHANNELS[color_type]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    filters = raw[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(filters.max())} is not defined")
    pixels = _unfilter(np.ascontiguousarray(raw[:, 1:]), filters, bpp)
    if depth == 16:
        return pixels.view(">u2").reshape(h, w).astype(np.uint16)
    return pixels.reshape((h, w) if channels == 1 else (h, w, channels))


def read_image(path) -> np.ndarray:
    """A PNG through ``read_png``; a JPEG through Pillow where it is
    installed (the array ``np.asarray`` of the opened image gives).  Any
    other file raises ``ValueError``."""
    path = Path(path)
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic.startswith(PNG_SIGNATURE):
        return read_png(path)
    if magic.startswith(b"\xff\xd8"):
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(f"{path}: JPEG needs Pillow, and no JPEG decoder is "
                             f"installed") from None
        with Image.open(path) as img:
            if img.mode not in ("L", "RGB"):
                raise ValueError(f"{path}: JPEG mode {img.mode} is not supported")
            return np.asarray(img)
    raise ValueError(f"{path}: not a PNG or JPEG file")


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the triangle filter: the first
    input index of each output sample, its tap count, and the [out, taps]
    weights normalised to sum 1 (float64); the support widens with the
    downscale factor."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the triangle's support, 1, times the scale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) casts in C truncate toward zero; negatives are clipped to 0.
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    arg = np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where(arg < 1.0, 1.0 - arg, 0.0)
    k = np.where(taps[None, :] < xmax[:, None], k, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # the C loop's summation order
        ww = ww + k[:, t]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    return xmin, xmax, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's separable resample along ``axis`` (1:
    horizontal, 0: vertical): uint8 in fixed point with 22 fractional bits
    and rounding to uint8; uint16 in float64, rounded half up."""
    in_size = img.shape[axis]
    xmin, xmax, k = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0)
    if img.dtype == np.uint8:
        kk = np.trunc(k * (1 << _PRECISION_BITS) + 0.5).astype(np.int64)
        acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    else:
        kk = k
        acc = np.zeros((out_size,) + src.shape[1:], np.float64)
    extra = (None,) * (src.ndim - 1)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc = acc + src[idx].astype(acc.dtype) * kk[(slice(None), t) + extra]
    if img.dtype == np.uint8:
        out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    else:
        out = np.clip(np.trunc(np.where(acc >= 0.0, acc + 0.5, acc - 0.5)),
                      0, 65535).astype(np.uint16)
    return np.moveaxis(out, 0, axis)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))``
    without Pillow: ``size`` is (width, height); ``img`` is uint8 [H, W],
    [H, W, 2], [H, W, 3], [H, W, 4] or uint16 [H, W].  As Pillow does, the
    colour of grey + alpha and RGBA images is resized premultiplied by alpha
    and divided back after, 8-bit images are resampled in fixed point with a
    horizontal then a vertical pass rounded to uint8 between them, a pass
    runs only along an axis whose size changes, and an unchanged size
    returns a copy."""
    out_w, out_h = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if img.dtype not in (np.uint8, np.uint16) or (img.dtype == np.uint16 and img.ndim != 2):
        raise ValueError(f"resize_bilinear: unsupported image {img.dtype} {img.shape}")
    if (out_w, out_h) == (w, h):
        return img.copy()
    alpha = img.ndim == 3 and img.shape[2] in (2, 4)
    if alpha:
        a = img[..., -1:].astype(np.int32)
        img = np.concatenate([_muldiv255(img[..., :-1], a), a], axis=-1).astype(np.uint8)
    if out_w != w:
        img = _resample_axis(img, out_w, 1)
    if out_h != h:
        img = _resample_axis(img, out_h, 0)
    if alpha:
        a = img[..., -1:].astype(np.int32)
        color = img[..., :-1].astype(np.int32)
        div = np.minimum(255 * color // np.maximum(a, 1), 255)
        color = np.where((a == 255) | (a == 0), color, div)
        img = np.concatenate([color, a], axis=-1).astype(np.uint8)
    return img
