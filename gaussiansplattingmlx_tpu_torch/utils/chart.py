"""A two-axis line chart drawn into a numpy RGB image, for the trainer's loss
curve (the JAX package draws it with matplotlib, which the port does not
use).  Text is a 3 x 5 pixel font scaled by 2."""

from __future__ import annotations

import numpy as np

_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111", ".": "000000000000010", "-": "000000111000000",
    "+": "000010111010000", "e": "000111101110011", "l": "110010010010111",
    "o": "000111101101111", "s": "000011110011110", "p": "000111101111100",
    "n": "000110101101101", "r": "000111100100100", "d": "001001111101111",
    "B": "110101110101110", "i": "010000010010010", "t": "010111010010011",
    "a": "000011101101011", "(": "010100100100010", ")": "010001001001010",
    " ": "000000000000000",
}
_SCALE = 2
BLACK = (0, 0, 0)
RED = (214, 39, 40)
BLUE = (31, 119, 180)


def _text(img: np.ndarray, s: str, x: int, y: int, color, anchor: str = "left") -> None:
    """Draw ``s`` with its top at row ``y``; ``x`` is its left edge, right
    edge or center as ``anchor`` says.  Characters without a glyph are
    skipped."""
    width = 4 * _SCALE * len(s)
    x = {"left": x, "right": x - width, "center": x - width // 2}[anchor]
    for i, ch in enumerate(s):
        bits = _GLYPHS.get(ch)
        if bits is None:
            continue
        glyph = np.array([int(b) for b in bits], bool).reshape(5, 3)
        glyph = glyph.repeat(_SCALE, 0).repeat(_SCALE, 1)
        gx = x + i * 4 * _SCALE
        ys, xs = np.nonzero(glyph)
        ys, xs = ys + y, xs + gx
        ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
        img[ys[ok], xs[ok]] = color


def _line(img: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    """A polyline through pixel coordinates, two pixels thick."""
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) * 2 + 2
        px = np.rint(np.linspace(x0, x1, n)).astype(int)
        py = np.rint(np.linspace(y0, y1, n)).astype(int)
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            qx, qy = px + dx, py + dy
            ok = (qx >= 0) & (qx < img.shape[1]) & (qy >= 0) & (qy < img.shape[0])
            img[qy[ok], qx[ok]] = color


def _span(values: np.ndarray):
    lo, hi = float(np.min(values)), float(np.max(values))
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    return lo, hi


def two_axis_chart(x, left, right, left_label: str, right_label: str,
                   x_label: str, width: int = 800, height: int = 400) -> np.ndarray:
    """uint8 [height, width, 3]: ``left`` (red, left axis) and ``right``
    (blue, right axis) against ``x``, with five ticks on each axis.
    Non-finite points are left out of a series."""
    img = np.full((height, width, 3), 255, np.uint8)
    x0, x1, y0, y1 = 80, width - 80, 30, height - 50
    x = np.asarray(x, np.float64)
    xlo, xhi = _span(x) if x.size else (0.0, 1.0)

    def px(v):
        return x0 + (v - xlo) / (xhi - xlo) * (x1 - x0)

    for series, color, edge, anchor in ((left, RED, x0 - 6, "right"),
                                        (right, BLUE, x1 + 6, "left")):
        v = np.asarray(series, np.float64)
        ok = np.isfinite(v)
        if not ok.any():
            continue
        lo, hi = _span(v[ok])

        def py(val, lo=lo, hi=hi):
            return y1 - (val - lo) / (hi - lo) * (y1 - y0)

        _line(img, px(x[ok]), py(v[ok]), color)
        for t in np.linspace(lo, hi, 5):
            yy = int(round(py(t)))
            _text(img, f"{t:.4g}", edge, yy - 5, color, anchor)
    for t in np.linspace(xlo, xhi, 5):
        xx = int(round(px(t)))
        img[y1:y1 + 5, xx] = BLACK
        _text(img, f"{t:.0f}", xx, y1 + 9, BLACK, "center")
    img[y0, x0:x1 + 1] = img[y1, x0:x1 + 1] = BLACK
    img[y0:y1 + 1, x0] = img[y0:y1 + 1, x1] = BLACK
    _text(img, left_label, x0, y0 - 16, RED)
    _text(img, right_label, x1, y0 - 16, BLUE, "right")
    _text(img, x_label, (x0 + x1) // 2, height - 18, BLACK, "center")
    return img
