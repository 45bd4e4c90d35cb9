"""Filled shapes, lines and a small Gaussian blur without cv2, equal to
cv2's pixel for pixel.

Each function draws in place on an (H, W, C) float32 or float64 image or
an (H, W) uint8 mask, as OpenCV's `imgproc/drawing.cpp` draws with
`LINE_8` and shift 0. The geometry is OpenCV's integer arithmetic
(16-bit fixed point, C's truncating division), so the covered pixels are
the same; a color is a tuple of floats, converted to the image's dtype as
cv2 converts a `Scalar` (float32: rounded to float32; uint8: rounded half
to even and saturated).

* `fill_poly`: `cv2.fillPoly(img, [pts], color)`, the edge-collection
  scanline fill (even-odd), and each edge's 8-connected outline.
* `box_points`: `cv2.boxPoints(((cx, cy), (w, h), angle))` in float32.
* `fill_ellipse`: `cv2.ellipse(img, center, axes, angle, 0, 360, color,
  -1)`: `ellipse2Poly` on OpenCV's float sine table with its step by axis
  size, then the convex fill.
* `rectangle`, `circle`: filled (`thickness=-1`).
* `line`: `cv2.line(img, p0, p1, color, thickness)`, thickness 1 a
  Bresenham line, more than 1 the stroke polygon and its round caps.
* `polylines`: `cv2.polylines(img, [pts], True, color, thickness)`, a
  closed outline of such lines.
* `gaussian_blur`: `cv2.GaussianBlur(img, (k, k), 0)` for k = 3 or 5:
  OpenCV's fixed small kernels, a separable row then column pass with
  `BORDER_REFLECT_101`, in the image's float dtype, the taps summed in
  cv2's order.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from .imageio import _fma

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cv_round(v: float) -> int:
    """cvRound: nearest integer, ties to even."""
    return int(round(v))


def _raw_color(img: np.ndarray, color) -> np.ndarray:
    """`color` as cv2's scalarToRawData gives it for `img`'s type: one value
    a channel."""
    c = np.atleast_1d(np.asarray(color, np.float64))
    n = 1 if img.ndim == 2 else img.shape[2]
    c = np.concatenate([c, np.zeros(max(0, n - c.size))])[:n]
    if img.dtype == np.uint8:
        return np.clip(np.rint(c), 0, 255).astype(np.uint8)
    return c.astype(img.dtype)


class _Canvas:
    """An image and its raw color; collects pixels and row spans, and
    writes them once, inside their bounding box (every primitive here
    paints a single color, so the order of writes does not matter)."""

    def __init__(self, img: np.ndarray, color):
        if img.dtype not in (np.float32, np.float64, np.uint8):
            raise ValueError(f"draw takes float32, float64 or uint8, not "
                             f"{img.dtype}")
        self.img = img
        self.h, self.w = img.shape[:2]
        self.color = _raw_color(img, color)
        self._pts: List[Tuple[np.ndarray, np.ndarray]] = []
        self._spans: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def points(self, xs, ys) -> None:
        xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
        ok = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        if ok.any():
            self._pts.append((xs[ok], ys[ok]))

    def spans(self, ys, x1s, x2s) -> None:
        """Row `ys[i]` from `x1s[i]` to `x2s[i]` inclusive; the caller has
        clipped them to the image."""
        ys, x1s, x2s = (np.asarray(a, np.int64) for a in (ys, x1s, x2s))
        keep = x2s >= x1s
        if keep.any():
            self._spans.append((ys[keep], x1s[keep], x2s[keep]))

    def flush(self) -> None:
        if not self._pts and not self._spans:
            return
        ys = [p[1] for p in self._pts] + [s[0] for s in self._spans]
        xlo = [p[0] for p in self._pts] + [s[1] for s in self._spans]
        xhi = [p[0] for p in self._pts] + [s[2] for s in self._spans]
        y0 = min(int(a.min()) for a in ys)
        y1 = max(int(a.max()) for a in ys)
        x0 = min(int(a.min()) for a in xlo)
        x1 = max(int(a.max()) for a in xhi)
        hh, ww = y1 - y0 + 1, x1 - x0 + 1
        mask = np.zeros((hh, ww), bool)
        if self._spans:
            sy = np.concatenate([s[0] for s in self._spans]) - y0
            sa = np.concatenate([s[1] for s in self._spans]) - x0
            sb = np.concatenate([s[2] for s in self._spans]) - x0
            diff = np.zeros((hh, ww + 1), np.int32)
            np.add.at(diff, (sy, sa), 1)
            np.add.at(diff, (sy, sb + 1), -1)
            mask = np.cumsum(diff[:, :ww], axis=1) > 0
        for xs, ys_ in self._pts:
            mask[ys_ - y0, xs - x0] = True
        sub = self.img[y0:y1 + 1, x0:x1 + 1]
        sub[mask] = self.color if self.img.ndim == 3 else self.color[0]
        self._pts, self._spans = [], []


# --- lines -------------------------------------------------------------

def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine on an image of w x h: (inside, x1, y1, x2, y2), the
    points moved as OpenCV moves them (also when the answer is no)."""
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(cv: _Canvas, p0, p1) -> None:
    """cv2's `Line` (LINE_8, integer end points): LineIterator's
    Bresenham, clipped first, always walked left to right."""
    x1, y1 = int(p0[0]), int(p0[1])
    x2, y2 = int(p1[0]), int(p1[1])
    if not (0 <= x1 < cv.w and 0 <= x2 < cv.w and 0 <= y1 < cv.h
            and 0 <= y2 < cv.h):
        ok, x1, y1, x2, y2 = _clip_line(cv.w, cv.h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # the minor coordinate after i steps: err starts at dx - 2 dy and a
    # step moves the minor axis when err < 0, so the moves after i steps
    # are the least k with 2 dx k >= 2 dy i - dx
    i = np.arange(dx + 1, dtype=np.int64)
    k = np.maximum(0, -((dx - 2 * dy * i) // (2 * dx))) if dx else i * 0
    if vert:
        cv.points(x1 + k, y1 + sy * i)
    else:
        cv.points(x1 + i, y1 + sy * k)


def _line2(cv: _Canvas, p0, p1) -> None:
    """cv2's `Line2`: an 8-connected line between 16-bit fixed-point end
    points, stepped in fixed point."""
    ok, x1, y1, x2, y2 = _clip_line(cv.w << XY_SHIFT, cv.h << XY_SHIFT,
                                    int(p0[0]), int(p0[1]),
                                    int(p1[0]), int(p1[1]))
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    half = XY_ONE >> 1
    cv.points([(x2 + half) >> XY_SHIFT], [(y2 + half) >> XY_SHIFT])
    if ecount < 0:
        return
    i = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        cv.points((x1 >> XY_SHIFT) + i, (y1 + step * i) >> XY_SHIFT)
    else:
        cv.points((x1 + step * i) >> XY_SHIFT, (y1 >> XY_SHIFT) + i)


# --- fills -------------------------------------------------------------

def _fill_convex(cv: _Canvas, v: Sequence[Tuple[int, int]],
                 shift: int) -> None:
    """cv2's `FillConvexPoly` (LINE_8): the outline, then two edge chains
    walked from the top vertex, one span a row."""
    npts = len(v)
    if npts == 0:
        return
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    p0x, p0y = v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        px, py = px << (XY_SHIFT - shift), py << (XY_SHIFT - shift)
        if shift == 0:
            _line8(cv, (p0x >> XY_SHIFT, p0y >> XY_SHIFT),
                   (px >> XY_SHIFT, py >> XY_SHIFT))
        else:
            _line2(cv, (p0x, p0y), (px, py))
        p0x, p0y = px, py
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= cv.w or ymin >= cv.h:
        return
    ymax = min(ymax, cv.h - 1)
    idx = [imin, imin]
    di = [1, npts - 1]
    ye = [ymin, ymin]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    edges = npts
    y = ymin
    rows, x1s, x2s = [], [], []
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx[i]
                nxt = idx0 + di[i]
                if nxt >= npts:
                    nxt -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[nxt][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[nxt][0] << (XY_SHIFT - shift)
                        ye[i] = ty
                        edx[i] = _tdiv((xe - xs) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs
                        idx[i] = nxt
                        break
                    idx0 = nxt
                    nxt += di[i]
                    if nxt >= npts:
                        nxt -= npts
                else:   # C's `edges-- > 0` decrements on its failing test
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + half) >> XY_SHIFT
            xx2 = (ex[right] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < cv.w:
                rows.append(y)
                x1s.append(max(xx1, 0))
                x2s.append(min(xx2, cv.w - 1))
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break
    cv.spans(rows, x1s, x2s)


def _collect_edges(cv: _Canvas, v, edges: List[Tuple[int, int, int, int]]
                   ) -> None:
    """cv2's `CollectPolyEdges` (LINE_8, shift 0): draws each edge's
    outline and adds the non-horizontal ones as (y0, y1, x, dx), x in
    16-bit fixed point at row y0. An edge that leaves the image takes
    the x of its clipped end points (`clipLine`), and their y too unless
    the clipped line is flat."""
    half = XY_ONE >> 1
    pt0 = (v[-1][0] << XY_SHIFT, v[-1][1])
    for px, py in v:
        pt1 = (px << XY_SHIFT, py)
        t0 = ((pt0[0] + half) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + half) >> XY_SHIFT, pt1[1])
        _line8(cv, t0, t1)
        c0, c1 = list(pt0), list(pt1)
        if not all(0 <= t[0] < cv.w and 0 <= t[1] < cv.h for t in (t0, t1)):
            _, ax, ay, bx, by = _clip_line(cv.w, cv.h, *t0, *t1)
            if ay != by:
                c0[1], c1[1] = ay, by
            c0[0], c1[0] = ax << XY_SHIFT, bx << XY_SHIFT
        if pt0[1] != pt1[1]:
            dy = c1[1] - c0[1]
            dx = _tdiv(c1[0] - c0[0], dy) if dy else 0
            if pt0[1] < pt1[1]:
                edges.append((pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx,
                              dx))
            else:
                edges.append((pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx,
                              dx))
        pt0 = pt1


def _fill_edges(cv: _Canvas, edges) -> None:
    """cv2's `FillEdgeCollection` (LINE_8): on each row, the active edges
    sorted by x and filled pairwise (even-odd), from the first pixel at
    or right of the left edge to the last at or left of the right one."""
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    y0, y1, x, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    xend = x + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= cv.h or max(x.max(), xend.max()) < 0
            or min(x.min(), xend.min()) >= cv.w << XY_SHIFT):
        return
    lo, hi = max(int(y0.min()), 0), min(int(y1.max()), cv.h)
    if lo >= hi:
        return
    # every (edge, row) with y0 <= row < y1 inside [lo, hi)
    a = np.maximum(y0, lo)
    n = np.maximum(np.minimum(y1, hi) - a, 0)
    eid = np.repeat(np.arange(len(e)), n)
    row = a[eid] + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    xr = x[eid] + (row - y0[eid]) * dx[eid]
    order = np.lexsort((xr, row))
    row, xr = row[order], xr[order]
    # pair the sorted edges of each row: (1st, 2nd), (3rd, 4th), ...
    start = np.r_[0, np.flatnonzero(np.diff(row)) + 1]
    rank = np.arange(row.size) - np.repeat(start, np.diff(np.r_[start,
                                                                row.size]))
    first = np.flatnonzero((rank[:-1] % 2 == 0) & (row[1:] == row[:-1]))
    x1 = (xr[first] + XY_ONE - 1) >> XY_SHIFT
    x2 = xr[first + 1] >> XY_SHIFT
    keep = (x1 < cv.w) & (x2 >= 0)
    cv.spans(row[first][keep], np.maximum(x1[keep], 0),
             np.minimum(x2[keep], cv.w - 1))


def fill_poly(img: np.ndarray, polys, color) -> np.ndarray:
    """`cv2.fillPoly(img, polys, color)` with LINE_8 and shift 0: each
    polygon an (N, 2) array of integer points."""
    cv = _Canvas(img, color)
    edges: List[Tuple[int, int, int, int]] = []
    for p in polys:
        pts = [(int(a), int(b)) for a, b in np.asarray(p).reshape(-1, 2)]
        if pts:
            _collect_edges(cv, pts, edges)
    _fill_edges(cv, edges)
    cv.flush()
    return img


def box_points(center, size, angle: float) -> np.ndarray:
    """`cv2.boxPoints((center, size, angle))`: the 4 corners (4, 2)
    float32 of the rotated rectangle, in float32 arithmetic as
    `RotatedRect::points` takes them."""
    f = np.float32
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    ang = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(ang)) * f(0.5)
    a = f(math.sin(ang)) * f(0.5)
    p0x = cx - a * h - b * w
    p0y = cy + b * h - a * w
    p1x = cx + a * h - b * w
    p1y = cy - b * h - a * w
    return np.array([[p0x, p0y], [p1x, p1y],
                     [cx + a * h + b * w, cy - b * h + a * w],
                     [cx - a * h + b * w, cy + b * h + a * w]], np.float32)


def rectangle(img: np.ndarray, p0, p1, color) -> np.ndarray:
    """`cv2.rectangle(img, p0, p1, color, -1)`: filled, clipped."""
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    cv = _Canvas(img, color)
    _fill_convex(cv, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)], 0)
    cv.flush()
    return img


def _circle_spans(cv: _Canvas, cx: int, cy: int, r: int) -> None:
    """cv2's `Circle` with fill: the midpoint circle's rows."""
    dxs, dys = [], []
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        dxs.append(dx)
        dys.append(dy)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    dxs, dys = np.asarray(dxs, np.int64), np.asarray(dys, np.int64)
    ys = np.concatenate([cy - dys, cy + dys, cy - dxs, cy + dxs])
    hw = np.concatenate([dxs, dxs, dys, dys])
    x1 = np.maximum(cx - hw, 0)
    x2 = np.minimum(cx + hw, cv.w - 1)
    ok = (ys >= 0) & (ys < cv.h) & (cx - hw < cv.w) & (cx + hw >= 0)
    cv.spans(ys[ok], x1[ok], x2[ok])


def circle(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, -1)`: filled, LINE_8."""
    cv = _Canvas(img, color)
    _circle_spans(cv, int(center[0]), int(center[1]), int(radius))
    cv.flush()
    return img


# OpenCV's `SinTable` (drawing.cpp): sin of 0..450 degrees as float
# literals of 7 decimals
_SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7)
                       for d in range(451)], np.float32)


def _ellipse2poly(cx: float, cy: float, ax: float, ay: float, angle: int,
                  delta: int) -> List[Tuple[float, float]]:
    """cv2's `ellipse2Poly` (double version) for the whole turn."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha = float(_SIN_TABLE[450 - angle])   # cos
    beta = float(_SIN_TABLE[angle])          # sin
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = ax * float(_SIN_TABLE[450 - a])
        y = ay * float(_SIN_TABLE[a])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    return pts


def _ellipse_poly(cx: int, cy: int, ax: int, ay: int, angle: int):
    """`EllipseEx`'s polygon in 16-bit fixed point, for a center and axes
    already in fixed point: the step by axis size (90, 30, 18 or 5
    degrees below 3, 10 and 15 px), rounded, repeats dropped."""
    ax, ay = abs(ax), abs(ay)
    d = (max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    v: List[Tuple[int, int]] = []
    for fx, fy in _ellipse2poly(float(cx), float(cy), float(ax), float(ay),
                                angle, delta):
        px = _cv_round(fx / XY_ONE) << XY_SHIFT
        py = _cv_round(fy / XY_ONE) << XY_SHIFT
        px += _cv_round(fx - px)
        py += _cv_round(fy - py)
        if not v or v[-1] != (px, py):
            v.append((px, py))
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    return v


def fill_ellipse(img: np.ndarray, center, axes, angle: float,
                 color) -> np.ndarray:
    """`cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`: a
    filled whole ellipse, LINE_8, shift 0 (cv2 rounds the angle to whole
    degrees)."""
    cv = _Canvas(img, color)
    v = _ellipse_poly(int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT,
                      int(axes[0]) << XY_SHIFT, int(axes[1]) << XY_SHIFT,
                      _cv_round(angle))
    _fill_convex(cv, v, XY_SHIFT)
    cv.flush()
    return img


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, thickness)`, LINE_8, integer points:
    thickness 1 is Bresenham's line; thicker lines are cv2's `ThickLine`,
    the stroke's quadrilateral in fixed point with a filled circle of
    radius (thickness + 1) // 2 at each end."""
    cv = _Canvas(img, color)
    _thick_line(cv, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
                int(thickness), 3)
    cv.flush()
    return img


def polylines(img: np.ndarray, pts, color, thickness: int = 1
              ) -> np.ndarray:
    """`cv2.polylines(img, [pts], True, color, thickness)`: the closed
    outline, LINE_8."""
    v = [(int(a), int(b)) for a, b in np.asarray(pts).reshape(-1, 2)]
    if not v:
        return img
    cv = _Canvas(img, color)
    p0 = v[-1]
    for p1 in v:
        _thick_line(cv, p0, p1, thickness, 2)
        p0 = p1
    cv.flush()
    return img


def _thick_line(cv: _Canvas, p0, p1, thickness: int, flags: int) -> None:
    """cv2's `ThickLine` for integer points, LINE_8: a thick line is first
    clipped to the image grown by `thickness` on every side."""
    if thickness <= 1:
        _line8(cv, p0, p1)
        return
    m = thickness
    ok, x1, y1, x2, y2 = _clip_line(cv.w + 2 * m, cv.h + 2 * m, p0[0] + m,
                                    p0[1] + m, p1[0] + m, p1[1] + m)
    if not ok:
        return
    p0, p1 = (x1 - m, y1 - m), (x2 - m, y2 - m)
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex(cv, [(p0[0] + ddx, p0[1] + ddy),
                          (p0[0] - ddx, p0[1] - ddy),
                          (p1[0] - ddx, p1[1] - ddy),
                          (p1[0] + ddx, p1[1] + ddy)], XY_SHIFT)
    half = XY_ONE >> 1
    for i in range(2):
        if flags & (i + 1):
            _circle_spans(cv, (p0[0] + half) >> XY_SHIFT,
                          (p0[1] + half) >> XY_SHIFT,
                          (t + half) >> XY_SHIFT)
        p0 = p1


# --- blur --------------------------------------------------------------

def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.GaussianBlur(img, (k, k), 0)` of a float32 or float64 image,
    k = 3 or 5: OpenCV's fixed kernels (1 2 1)/4 and (1 4 6 4 1)/16, a
    row pass then a column pass with `BORDER_REFLECT_101`, each rounded
    to the image's dtype. The taps are summed as cv2's x86 build sums
    them (its filters run with fused multiply-adds):

    * rows, float32: (l1 + r1) k1 + c k0, and for k = 5
      (l2 + r2) k2 + fma(c, k0, (l1 + r1) k1);
    * rows, float64: left to right, each tap fused into the sum;
    * for k = 5 a row's last (W C) % 2 (float32) or % 4 (float64) values
      are summed as the plain c k0 + (l1 + r1) k1 + (l2 + r2) k2 (float32)
      or left to right (float64), unfused (cv2's scalar tail);
    * columns: c k0 + (l1 + r1) k1 [+ (l2 + r2) k2].

    Only the 3/8 tap's product is inexact, so only where it is fused
    does the order of fusing show."""
    if k not in (3, 5):
        raise ValueError("gaussian_blur takes k = 3 or 5")
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"gaussian_blur takes float32 or float64, not "
                         f"{img.dtype}")
    dt = img.dtype.type
    r = k // 2

    def taps(a: np.ndarray, axis: int):
        n = a.shape[axis]
        idx = np.abs(np.arange(-r, n + r))
        idx = np.where(idx > n - 1, 2 * (n - 1) - idx, idx)
        idx = np.clip(idx, 0, n - 1)
        p = np.take(a, idx, axis=axis)
        out = []
        for off in range(k):
            s = [slice(None)] * a.ndim
            s[axis] = slice(off, off + n)
            out.append(p[tuple(s)])
        return out

    q, h, s = dt(0.25), dt(0.5), dt(0.0625)
    t = taps(img, 1)
    if k == 3:
        row = (t[0] * q + t[1] * h) + t[2] * q if dt is np.float64 \
            else (t[0] + t[2]) * q + t[1] * h
    else:
        if dt is np.float64:
            row = _fma(t[4], 0.0625, _fma(t[3], 0.25, _fma(
                t[2], 0.375, t[0] * s + t[1] * q)))
            plain = (((t[0] * s + t[1] * q) + t[2] * dt(0.375)) + t[3] * q) \
                + t[4] * s
            lanes = 4
        else:
            row = (t[0] + t[4]) * s + _fma(t[2], 0.375, (t[1] + t[3]) * q)
            plain = (t[2] * dt(0.375) + (t[1] + t[3]) * q) + (t[0] + t[4]) * s
            lanes = 2
        # a row's last (W C) % lanes values are cv2's scalar tail, unfused
        n = row[0].size
        tail = n % lanes
        if tail:
            flat, pl = row.reshape(row.shape[0], n), plain.reshape(
                row.shape[0], n)
            flat[:, n - tail:] = pl[:, n - tail:]
    t = taps(row, 0)
    if k == 3:
        return t[1] * h + (t[0] + t[2]) * q
    return (t[2] * dt(0.375) + (t[1] + t[3]) * q) + (t[0] + t[4]) * s
