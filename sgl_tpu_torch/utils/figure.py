"""A raster figure of the port's own, for the scatter plots of
``clustering_metrics.plotClusters``, and a PNG writer and reader on
``zlib`` alone (``sgl_tpu`` draws with matplotlib, which the port does not
use).

The figure keeps matplotlib's defaults for what such a plot shows: a
6.4 × 4.8 inch canvas (768 × 576 pixels at 120 dpi) on white, one subplot
in the box left/right/bottom/top 0.125/0.9/0.11/0.88 of the figure, its
limits autoscaled on the scatter offsets with 5% margins, the y axis up.
:meth:`Axes.scatter` draws filled discs of diameter ``sqrt(s) + lw``
points (``s`` the marker area in points², ``lw`` the edge in the face
colour), each centred on the centre of the pixel whose top-left corner is
nearest its point (as matplotlib's Agg backend places markers) and
anti-aliased by the area of each pixel the disc covers (the disc's edge
taken as straight across a pixel); a later call is drawn on top.  The
figure draws the scatter alone: no frame, ticks or labels, the axis on or
off (``plotClusters`` turns it off).  The 5% margins keep a disc (radius
``sqrt(s)/2 · dpi/72`` pixels, 5.27 at ``s = 40`` and 120 dpi) inside the
axes, so nothing is clipped.

Colours are the CSS names ``sgl_tpu`` uses, ``#rrggbb`` strings, and RGB or
RGBA tuples of floats in [0, 1].
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np

CSS_COLORS = {
    "red": "#ff0000", "green": "#008000", "blue": "#0000ff", "brown": "#a52a2a",
    "purple": "#800080", "yellow": "#ffff00", "pink": "#ffc0cb", "orange": "#ffa500",
}
FIGSIZE = (6.4, 4.8)  # inches
DPI = 100.0  # matplotlib's figure.dpi
SUBPLOT_BOX = (0.125, 0.9, 0.11, 0.88)  # left, right, bottom, top
MARGIN = 0.05
DEFAULT_SIZE = 36.0  # lines.markersize ** 2
DEFAULT_LINEWIDTH = 1.5  # lines.linewidth, the scatter edge
DEFAULT_COLOR = "#1f77b4"  # the first colour of the property cycle
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_rgba(color) -> tuple:
    """``color`` (a CSS name of :data:`CSS_COLORS`, ``#rrggbb``, or 3 or 4
    floats in [0, 1]) as 4 floats in [0, 1]."""
    if isinstance(color, str):
        hexa = CSS_COLORS.get(color.lower(), color)
        if not (hexa.startswith("#") and len(hexa) == 7):
            raise ValueError(f"unknown colour {color!r}")
        return tuple(int(hexa[i:i + 2], 16) / 255.0 for i in (1, 3, 5)) + (1.0,)
    rgba = tuple(float(v) for v in color)
    if len(rgba) not in (3, 4) or not all(0.0 <= v <= 1.0 for v in rgba):
        raise ValueError(f"not an RGB(A) colour in [0, 1]: {color!r}")
    return rgba if len(rgba) == 4 else rgba + (1.0,)


def _edge_coverage(t: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The share of a unit pixel on the inner side of a straight edge that
    passes at signed distance ``t`` from the pixel's centre (positive:
    the centre inside), the edge's normal ``(a, b)`` with ``a ≥ b ≥ 0``:
    the distribution of the sum of two uniforms of widths ``a`` and ``b``."""
    h = (a + b) / 2
    flat = (a - b) / 2
    safe_b = np.maximum(b, 1e-12)
    ramp = np.where(t <= -flat, (t + h) ** 2 / (2 * a * safe_b),
                    np.where(t < flat, b / (2 * a) + (t + flat) / a, 1 - (h - t) ** 2 / (2 * a * safe_b)))
    straight = np.clip(t / a + 0.5, 0.0, 1.0)
    return np.where(t <= -h, 0.0, np.where(t >= h, 1.0, np.where(b < 1e-6, straight, ramp)))


class Axes:
    """One subplot: its scatter collections."""

    def __init__(self):
        self.collections = []  # (offsets [n, 2] float64, diameter in points, rgba)

    def scatter(self, x, y, s=DEFAULT_SIZE, c=DEFAULT_COLOR, lw=DEFAULT_LINEWIDTH):
        """Discs at ``(x, y)`` of area ``s`` points² in the one colour ``c``,
        with an edge of ``lw`` points in the same colour."""
        offsets = np.column_stack([np.asarray(x, np.float64).reshape(-1), np.asarray(y, np.float64).reshape(-1)])
        self.collections.append((offsets, math.sqrt(float(s)) + float(lw), to_rgba(c)))

    def axis(self, arg: str) -> None:
        """``"on"`` or ``"off"``: the figure draws no axis either way."""
        if arg not in ("on", "off"):
            raise ValueError(f"axis({arg!r}): only 'on' and 'off'")

    def _limits(self, k: int) -> tuple:
        """Data limits of coordinate ``k`` with the margins, as matplotlib's
        autoscale (a single value widened by 5% of itself, 0 to ±0.05)."""
        vals = [o[:, k] for o, _, _ in self.collections if len(o)]
        if not vals:
            return 0.0, 1.0
        lo, hi = float(min(v.min() for v in vals)), float(max(v.max() for v in vals))
        if hi - lo > 0:
            span = hi - lo
            return lo - MARGIN * span, hi + MARGIN * span
        return (lo - MARGIN * abs(lo), hi + MARGIN * abs(hi)) if lo else (-MARGIN, MARGIN)

    def _draw(self, canvas: np.ndarray, dpi: float) -> None:
        """Composite every collection onto ``canvas`` ([H, W, 3] floats in
        [0, 1], row 0 at the top)."""
        height, width = canvas.shape[:2]
        left, right, bottom, top = SUBPLOT_BOX
        x0, x1 = left * width, right * width
        y0, y1 = bottom * height, top * height
        (xlo, xhi), (ylo, yhi) = self._limits(0), self._limits(1)
        for offsets, diameter, rgba in self.collections:
            if not len(offsets):
                continue
            radius = diameter / 2 * dpi / 72.0
            # display coordinates, x right and y down from the top-left
            # corner, each centre moved to a pixel's centre as Agg's marker
            # drawing moves it
            u = np.floor(x0 + (offsets[:, 0] - xlo) / (xhi - xlo) * (x1 - x0) + 0.5) + 0.5
            v = np.floor(height - (y0 + (offsets[:, 1] - ylo) / (yhi - ylo) * (y1 - y0)) + 0.5) + 0.5
            reach = int(math.ceil(radius + 1))
            grid = np.arange(-reach, reach + 1)
            cols = np.floor(u)[:, None, None].astype(np.int64) + grid[None, None, :]
            rows = np.floor(v)[:, None, None].astype(np.int64) + grid[None, :, None]
            dx = cols + 0.5 - u[:, None, None]
            dy = rows + 0.5 - v[:, None, None]
            dist = np.hypot(dx, dy)
            safe = np.maximum(dist, 1e-12)
            a = np.where(dist > 0, np.maximum(abs(dx), abs(dy)) / safe, 1.0)
            b = np.where(dist > 0, np.minimum(abs(dx), abs(dy)) / safe, 0.0)
            alpha = _edge_coverage(radius - dist, a, b) * rgba[3]
            rows, cols = np.broadcast_arrays(rows, cols)
            keep = (alpha > 0) & (rows >= 0) & (rows < height) & (cols >= 0) & (cols < width)
            # one colour: the discs' "over" compositing multiplies the
            # transparencies, in any order
            clear = np.ones((height, width))
            np.multiply.at(clear, (rows[keep], cols[keep]), 1.0 - alpha[keep])
            canvas *= clear[:, :, None]
            canvas += (1.0 - clear)[:, :, None] * np.asarray(rgba[:3])


class Figure:
    """A white canvas of :data:`FIGSIZE` inches holding one :class:`Axes`."""

    def __init__(self):
        self._axes: Optional[Axes] = None

    def add_subplot(self, *args) -> Axes:
        """The one subplot, ``add_subplot(1, 1, 1)``."""
        if args != (1, 1, 1):
            raise ValueError(f"add_subplot{args}: the figure holds one subplot, (1, 1, 1)")
        self._axes = Axes()
        return self._axes

    def gca(self) -> Axes:
        return self._axes or self.add_subplot(1, 1, 1)

    def render(self, dpi: float = DPI) -> np.ndarray:
        """The picture as an [H, W, 4] uint8 RGBA array, row 0 at the top."""
        width, height = (int(round(v * dpi)) for v in FIGSIZE)
        canvas = np.ones((height, width, 3))
        if self._axes is not None:
            self._axes._draw(canvas, dpi)
        rgba = np.full((height, width, 4), 255, np.uint8)
        rgba[:, :, :3] = np.clip(np.rint(canvas * 255.0), 0, 255).astype(np.uint8)
        return rgba

    def savefig(self, path, dpi: float = DPI) -> None:
        """Write the picture at ``dpi`` to ``path`` as an 8-bit RGBA PNG."""
        write_png(path, self.render(dpi))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def write_png(path, rgba: np.ndarray) -> None:
    """``rgba`` ([H, W, 4] uint8) to ``path`` as an 8-bit RGBA PNG: filter 0
    on every row, one ``zlib`` stream."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    height, width, channels = rgba.shape
    if channels != 4:
        raise ValueError(f"expected [H, W, 4] RGBA, got {rgba.shape}")
    raw = np.zeros((height, 1 + 4 * width), np.uint8)
    raw[:, 1:] = rgba.reshape(height, -1)
    png = (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced RGB or RGBA PNG as an [H, W, 3 or 4] uint8
    array; every chunk's CRC is checked and all five row filters are undone
    (Paeth row by row in Python, slowly)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA (depth {depth}, colour type {color})")
    bpp = 3 if color == 2 else 4
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(height):
        kind, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:
            # x[i] = line[i] + x[i - bpp]: a running sum along each channel
            cur = (np.cumsum(line.reshape(width, bpp), axis=0) & 0xFF).reshape(-1)
        elif kind in (3, 4):
            cur = line.copy()
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                pred = (a + b) // 2 if kind == 3 else _paeth(a, b, int(prev[i - bpp]) if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: unknown row filter {kind}")
        out[r] = cur
        prev = cur.astype(np.int32)
    return out.reshape(height, width, bpp)
