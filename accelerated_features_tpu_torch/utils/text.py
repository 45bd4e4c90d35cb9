"""`cv2.putText` without cv2: the text of OpenCV 5.0.0 on uint8 images.

OpenCV 5 draws `putText` with TrueType fonts built into the library: its
eight Hershey faces map to the variable font Rubik (faces 0-5) or Rubik
Italic (faces 6-7) at a pixel size and a weight that follow from the
face, the scale and the thickness (`hersheyToTruetype`). The two fonts
are committed under `assets/fonts/`, copied byte for byte from the gzip
members inside cv2 5.0.0's `cv2.abi3.so` (SIL Open Font License, see
`assets/fonts/NOTICE`).

This module reads them with a small TrueType reader (`cmap` format 4,
`loca`/`glyf` quadratic outlines with composite glyphs, `hhea`/`hmtx`
advances, and the variable-font tables `fvar`, `avar`, `gvar` with its
interpolation of untouched points, and `HVAR`) and draws as
stb_truetype, which OpenCV's text is built on, draws: the varied points
floored to integers, quadratic curves flattened to 0.35 px, and each
pixel's exact covered area (the nonzero winding's signed area, clamped)
as the glyph's alpha; the pen advances by the floored advance in font
units, scaled by size / ascent, rounded to 1/64 px and floored. Fonts
use no kerning in cv2 5.0.0, and neither does this module.

`put_text(img, text, org, face, scale, color, thickness)` draws as
`cv2.putText(..., cv2.LINE_AA)` of cv2 5.0.0 does (its line type does not
change cv2 5.0.0's text). The face table below was found by probing cv2 5.0.0's `putText`
against its `FontFace` API (`tests/test_torch_text.py` holds it there).
Held to cv2 5.0.0 on 480 seeded draws of 6 characters at scales 0.5-3.0
(`tests/test_torch_text.py`): every pixel within 8 levels (measured: 4),
at most 2 % of a mask's inked pixels different (measured over all draws:
0.02 %), the ink's box equal within 1 px (measured: equal). Not
reproduced: at sizes near 100 px and more, cv2 clips a heavy weight's
glyph to a box smaller than its outline (e.g. ',' at weight 900 and
100 px); this module draws the whole outline. Other cv2 versions draw
other text (OpenCV 4 draws Hershey strokes), so the pixels are those of
cv2 5.0.0 only.
"""

from __future__ import annotations

import functools
import math
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

FONT_DIR = Path(__file__).resolve().parents[1] / "assets" / "fonts"

# cv2 5.0.0's hersheyToTruetype, probed: face -> (font file, pixels per
# unit of fontScale as 1 / k, weight at thickness 1, weight at thickness
# >= 2). The pixel size is cvRound(fontScale / k); Rubik's weight axis
# runs 300..900, so a weight below 300 draws at 300.
_FACES = {
    0: ("Rubik.ttf", 0.037, 400, 600),          # HERSHEY_SIMPLEX
    1: ("Rubik.ttf", 0.066, 400, 800),          # HERSHEY_PLAIN
    2: ("Rubik.ttf", 0.037, 600, 800),          # HERSHEY_DUPLEX
    3: ("Rubik.ttf", 0.037, 400, 800),          # HERSHEY_COMPLEX
    4: ("Rubik.ttf", 0.037, 600, 800),          # HERSHEY_TRIPLEX
    5: ("Rubik.ttf", 0.046, 400, 800),          # HERSHEY_COMPLEX_SMALL
    6: ("Rubik-Italic.ttf", 0.04, 300, 500),    # HERSHEY_SCRIPT_SIMPLEX
    7: ("Rubik-Italic.ttf", 0.04, 400, 600),    # HERSHEY_SCRIPT_COMPLEX
}


def hershey_to_truetype(face: int, scale: float, thickness: int
                        ) -> Tuple[str, int, int]:
    """(font file, pixel size, weight) that cv2 5.0.0 draws a Hershey
    `face` at `scale` and `thickness` with."""
    if face not in _FACES:
        raise ValueError(f"face is one of cv2's Hershey faces 0-7, not "
                         f"{face}")
    name, k, w1, w2 = _FACES[face]
    return name, int(round(scale / k)), (w1 if thickness <= 1 else w2)


# --- the TrueType reader -----------------------------------------------

def _f2dot14(v: int) -> float:
    return v / 16384.0


class _Reader:
    def __init__(self, data: bytes):
        self.d = data

    def u8(self, o):
        return self.d[o]

    def u16(self, o):
        return struct.unpack_from(">H", self.d, o)[0]

    def i16(self, o):
        return struct.unpack_from(">h", self.d, o)[0]

    def u32(self, o):
        return struct.unpack_from(">I", self.d, o)[0]

    def i32(self, o):
        return struct.unpack_from(">i", self.d, o)[0]


class Font:
    """One TrueType font file: its glyphs, advances and variations."""

    def __init__(self, path):
        data = Path(path).read_bytes()
        r = self.r = _Reader(data)
        if r.u32(0) != 0x00010000:
            raise ValueError(f"{path}: not a TrueType font")
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(r.u16(4)):
            o = 12 + 16 * i
            self.tables[data[o:o + 4].decode("latin-1")] = (r.u32(o + 8),
                                                            r.u32(o + 12))
        head = self.tables["head"][0]
        self.units_per_em = r.u16(head + 18)
        self.loc_long = r.i16(head + 50) == 1
        hhea = self.tables["hhea"][0]
        self.ascent = r.i16(hhea + 4)
        self.descent = r.i16(hhea + 6)
        self.n_hmetrics = r.u16(hhea + 34)
        self.n_glyphs = r.u16(self.tables["maxp"][0] + 4)
        self._cmap = self._read_cmap()
        self.axes = self._read_fvar()
        self._avar = self._read_avar()

    # cmap ----------------------------------------------------------
    def _read_cmap(self) -> Dict[int, int]:
        r = self.r
        base = self.tables["cmap"][0]
        sub = None
        for i in range(r.u16(base + 2)):
            o = base + 4 + 8 * i
            pid, eid = r.u16(o), r.u16(o + 2)
            off = base + r.u32(o + 4)
            if r.u16(off) == 4 and (pid, eid) in ((3, 1), (0, 3)):
                sub = off
        if sub is None:
            raise ValueError("font has no cmap format 4")
        segx2 = r.u16(sub + 6)
        ends = sub + 14
        starts = ends + segx2 + 2
        deltas = starts + segx2
        ranges = deltas + segx2
        out = {}
        for s in range(segx2 // 2):
            end, start = r.u16(ends + 2 * s), r.u16(starts + 2 * s)
            delta, ro = r.i16(deltas + 2 * s), r.u16(ranges + 2 * s)
            for c in range(start, min(end, 0xFFFE) + 1):
                if ro == 0:
                    g = (c + delta) & 0xFFFF
                else:
                    g = r.u16(ranges + 2 * s + ro + 2 * (c - start))
                    if g:
                        g = (g + delta) & 0xFFFF
                if g:
                    out[c] = g
        return out

    def glyph_index(self, ch: str) -> int:
        return self._cmap.get(ord(ch), 0)

    # variations ------------------------------------------------------
    def _read_fvar(self):
        if "fvar" not in self.tables:
            return []
        r, base = self.r, self.tables["fvar"][0]
        axes_off, n = r.u16(base + 4), r.u16(base + 8)
        size = r.u16(base + 10)
        axes = []
        for i in range(n):
            o = base + axes_off + i * size
            axes.append((self.r.d[o:o + 4].decode("latin-1"),
                         r.i32(o + 4) / 65536, r.i32(o + 8) / 65536,
                         r.i32(o + 12) / 65536))
        return axes

    def _read_avar(self):
        if "avar" not in self.tables:
            return None
        r, base = self.r, self.tables["avar"][0]
        o = base + 8
        maps = []
        for _ in range(r.u16(base + 6)):
            n = r.u16(o)
            pairs = [(_f2dot14(r.i16(o + 2 + 4 * k)),
                      _f2dot14(r.i16(o + 4 + 4 * k))) for k in range(n)]
            maps.append(pairs)
            o += 2 + 4 * n
        return maps

    def normalized(self, **user) -> Tuple[float, ...]:
        """The normalized coordinates (F2DOT14 values) of a location in
        user units, e.g. `wght=600`, clamped to each axis."""
        out = []
        for i, (tag, lo, default, hi) in enumerate(self.axes):
            v = min(max(float(user.get(tag, default)), lo), hi)
            if v < default:
                n = (v - default) / (default - lo)
            elif v > default:
                n = (v - default) / (hi - default)
            else:
                n = 0.0
            if self._avar is not None:
                n = _avar_map(self._avar[i], n)
            out.append(round(n * 16384) / 16384)
        return tuple(out)

    # glyphs -----------------------------------------------------------
    def _glyph_range(self, g: int) -> Tuple[int, int]:
        loca = self.tables["loca"][0]
        if self.loc_long:
            a, b = self.r.u32(loca + 4 * g), self.r.u32(loca + 4 * g + 4)
        else:
            a, b = 2 * self.r.u16(loca + 2 * g), \
                2 * self.r.u16(loca + 2 * g + 2)
        return self.tables["glyf"][0] + a, b - a

    def advance(self, g: int) -> int:
        r, hmtx = self.r, self.tables["hmtx"][0]
        return r.u16(hmtx + 4 * min(g, self.n_hmetrics - 1))

    def lsb(self, g: int) -> int:
        r, hmtx = self.r, self.tables["hmtx"][0]
        if g < self.n_hmetrics:
            return r.i16(hmtx + 4 * g + 2)
        return r.i16(hmtx + 4 * self.n_hmetrics + 2 * (g - self.n_hmetrics))

    def _simple(self, off: int, nc: int):
        """(points (N, 2) float64, on-curve flags (N,), contour ends)."""
        r = self.r
        ends = [r.u16(off + 10 + 2 * i) for i in range(nc)]
        n = ends[-1] + 1 if ends else 0
        o = off + 10 + 2 * nc
        o += 2 + r.u16(o)       # instructions
        flags = []
        while len(flags) < n:
            f = r.u8(o)
            o += 1
            flags.append(f)
            if f & 8:
                rep = r.u8(o)
                o += 1
                flags.extend([f] * rep)
        flags = flags[:n]
        coords = []
        for short, same in ((2, 16), (4, 32)):
            v, vals = 0, []
            for f in flags:
                if f & short:
                    d = r.u8(o)
                    o += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += r.i16(o)
                    o += 2
                vals.append(v)
            coords.append(vals)
        pts = np.stack([np.asarray(coords[0], np.float64),
                        np.asarray(coords[1], np.float64)], -1) \
            if n else np.zeros((0, 2))
        return pts, np.asarray([f & 1 for f in flags], bool), ends

    def glyph(self, g: int, coords: Tuple[float, ...]):
        """The outline of glyph `g` at normalized `coords`: (points,
        on-curve flags, contour ends, advance), points in font units
        (floats once varied), the advance varied by `HVAR` where the font
        has it, else by the glyph's phantom points."""
        return self._glyph(g, tuple(coords))

    @functools.lru_cache(maxsize=4096)
    def _glyph(self, g: int, coords: Tuple[float, ...]):
        off, length = self._glyph_range(g)
        adv = float(self.advance(g))
        if length == 0:
            # an empty glyph (the space) keeps its default advance, as
            # cv2 5.0.0 draws it
            return np.zeros((0, 2)), np.zeros(0, bool), [], adv
        nc = self.r.i16(off)
        if nc >= 0:
            pts, on, ends = self._simple(off, nc)
            xmin = float(self.r.i16(off + 2))
            allp = np.concatenate([pts, self._phantom(g, pts, xmin)])
            allp = self._vary(g, allp, ends, coords)
            pts, ph = allp[:-4], allp[-4:]
            adv = float(ph[1, 0] - ph[0, 0])
        else:
            pts, on, ends, adv = self._composite(g, off, coords)
        if "HVAR" in self.tables:
            adv = self.advance(g) + self.hvar_delta(g, coords)
        return pts, on, ends, adv

    def _phantom(self, g: int, pts, xmin: float) -> np.ndarray:
        left = xmin - self.lsb(g)
        return np.array([[left, 0.0], [left + self.advance(g), 0.0],
                         [0.0, 0.0], [0.0, 0.0]])

    def _composite(self, g: int, off: int, coords):
        r = self.r
        o = off + 10
        comps = []
        while True:
            flags, gi = r.u16(o), r.u16(o + 2)
            o += 4
            if flags & 1:
                a, b = r.i16(o), r.i16(o + 2)
                o += 4
            else:
                a, b = struct.unpack_from(">bb", r.d, o)
                o += 2
            m = np.eye(2)
            if flags & 8:
                m = np.eye(2) * _f2dot14(r.i16(o))
                o += 2
            elif flags & 0x40:
                m = np.diag([_f2dot14(r.i16(o)), _f2dot14(r.i16(o + 2))])
                o += 4
            elif flags & 0x80:
                m = np.array([[_f2dot14(r.i16(o)), _f2dot14(r.i16(o + 2))],
                              [_f2dot14(r.i16(o + 4)),
                               _f2dot14(r.i16(o + 6))]])
                o += 8
            if not flags & 2:
                raise ValueError("composite glyphs placed by point numbers "
                                 "are not supported")
            comps.append((gi, float(a), float(b), m, bool(flags & 0x200)))
            if not flags & 0x20:
                break
        # the component offsets vary as points, followed by the phantoms
        base = np.array([[c[1], c[2]] for c in comps], np.float64)
        xmin = float(r.i16(off + 2))
        allp = np.concatenate([base, self._phantom(g, base, xmin)])
        allp = self._vary(g, allp, [], coords, composite=True)
        pts_l, on_l, ends_l, n = [], [], [], 0
        adv = float(allp[-3, 0] - allp[-4, 0])
        for (gi, _, _, m, use_metrics), (dx, dy) in zip(comps, allp[:-4]):
            p, on, ends, cadv = self._glyph(gi, coords)
            p = p @ m + np.array([dx, dy])
            pts_l.append(p)
            on_l.append(on)
            ends_l.extend(e + n for e in ends)
            n += len(p)
            if use_metrics:
                adv = cadv
        pts = np.concatenate(pts_l) if pts_l else np.zeros((0, 2))
        on = np.concatenate(on_l) if on_l else np.zeros(0, bool)
        return pts, on, ends_l, adv

    def _vary(self, g: int, pts: np.ndarray, ends: List[int],
              coords: Tuple[float, ...], composite: bool = False
              ) -> np.ndarray:
        """`pts` (the glyph's points and its 4 phantom points) moved by the
        glyph's `gvar` deltas at `coords`."""
        if "gvar" not in self.tables or not any(coords):
            return pts
        r, base = self.r, self.tables["gvar"][0]
        axis_count = r.u16(base + 4)
        shared_count = r.u16(base + 6)
        shared_off = base + r.u32(base + 8)
        flags = r.u16(base + 14)
        data_base = base + r.u32(base + 16)
        if flags & 1:
            a, b = r.u32(base + 20 + 4 * g), r.u32(base + 24 + 4 * g)
        else:
            a, b = 2 * r.u16(base + 20 + 2 * g), 2 * r.u16(base + 22 + 2 * g)
        if a == b:
            return pts
        gv = data_base + a
        count = r.u16(gv)
        o_data = gv + r.u16(gv + 2)
        n_pts = len(pts)
        shared_points = None
        if count & 0x8000:
            shared_points, o_data = _packed_points(r, o_data, n_pts)
        out = pts.copy()
        o = gv + 4
        for _ in range(count & 0x0FFF):
            size, index = r.u16(o), r.u16(o + 2)
            o += 4
            if index & 0x8000:
                peak = [_f2dot14(r.i16(o + 2 * k)) for k in range(axis_count)]
                o += 2 * axis_count
            else:
                so = shared_off + (index & 0x0FFF) * 2 * axis_count
                peak = [_f2dot14(r.i16(so + 2 * k))
                        for k in range(axis_count)]
            start = end = None
            if index & 0x4000:
                start = [_f2dot14(r.i16(o + 2 * k)) for k in range(axis_count)]
                end = [_f2dot14(r.i16(o + 2 * axis_count + 2 * k))
                       for k in range(axis_count)]
                o += 4 * axis_count
            scalar = _tuple_scalar(coords, peak, start, end)
            p = o_data
            if index & 0x2000:
                points, p = _packed_points(r, p, n_pts)
            else:
                points = shared_points
            n = n_pts if points is None else len(points)
            xs, p = _packed_deltas(r, p, n)
            ys, p = _packed_deltas(r, p, n)
            o_data += size
            if scalar == 0:
                continue
            d = np.zeros((n_pts, 2))
            if points is None:
                d[:, 0], d[:, 1] = xs, ys
            else:
                idx = np.asarray(points, np.int64)
                ok = idx < n_pts
                d[idx[ok], 0] = np.asarray(xs)[ok]
                d[idx[ok], 1] = np.asarray(ys)[ok]
                if not composite:
                    touched = np.zeros(n_pts, bool)
                    touched[idx[ok]] = True
                    d = _iup(pts, d, touched, ends)
            out += scalar * d
        return out


    def hvar_delta(self, g: int, coords: Tuple[float, ...]) -> float:
        """The glyph's advance-width delta at `coords` from `HVAR` (its
        item variation store, through the advance-width index map)."""
        if "HVAR" not in self.tables or not any(coords):
            return 0.0
        r, base = self.r, self.tables["HVAR"][0]
        store = base + r.u32(base + 4)
        map_off = r.u32(base + 8)
        if map_off:
            m = base + map_off
            fmt, entry = r.u8(m), r.u8(m + 1)
            count = r.u16(m + 2) if fmt == 0 else r.u32(m + 2)
            data = m + (4 if fmt == 0 else 6)
            size = ((entry & 0x30) >> 4) + 1
            inner_bits = (entry & 0x0F) + 1
            i = min(g, count - 1)
            v = int.from_bytes(r.d[data + i * size:data + (i + 1) * size],
                               "big")
            outer, inner = v >> inner_bits, v & ((1 << inner_bits) - 1)
        else:
            outer, inner = 0, g
        regions = store + r.u32(store + 2)
        axis_count = r.u16(regions)
        ivd = store + r.u32(store + 8 + 4 * outer)
        item_count, word = r.u16(ivd), r.u16(ivd + 2)
        n_regions = r.u16(ivd + 4)
        long_words = bool(word & 0x8000)
        word &= 0x7FFF
        region_idx = [r.u16(ivd + 6 + 2 * k) for k in range(n_regions)]
        wsize, ssize = (4, 2) if long_words else (2, 1)
        row = word * wsize + (n_regions - word) * ssize
        o = ivd + 6 + 2 * n_regions + inner * row
        total = 0.0
        for k, ri in enumerate(region_idx):
            if k < word:
                d = (r.i32(o) if long_words else r.i16(o))
                o += wsize
            else:
                d = (r.i16(o) if long_words else
                     struct.unpack_from(">b", r.d, o)[0])
                o += ssize
            scalar = 1.0
            for a in range(axis_count):
                ro = regions + 4 + 6 * (ri * axis_count + a)
                st, pk, en = (_f2dot14(r.i16(ro)), _f2dot14(r.i16(ro + 2)),
                              _f2dot14(r.i16(ro + 4)))
                c = coords[a]
                if pk == 0 or st > pk or pk > en or (st < 0 < en):
                    continue
                if c < st or c > en:
                    scalar = 0.0
                    break
                if c != pk:
                    scalar *= (c - st) / (pk - st) if c < pk else \
                        (en - c) / (en - pk)
            total += scalar * d
        return total


def _avar_map(pairs, v: float) -> float:
    for (a0, b0), (a1, b1) in zip(pairs, pairs[1:]):
        if a0 <= v <= a1:
            if a1 == a0:
                return b0
            return b0 + (v - a0) * (b1 - b0) / (a1 - a0)
    return v


def _tuple_scalar(coords, peak, start, end) -> float:
    s = 1.0
    for k, (c, p) in enumerate(zip(coords, peak)):
        if p == 0 or c == p:
            continue
        if start is not None:
            lo, hi = start[k], end[k]
            if lo > p or p > hi or (lo < 0 < hi and p != 0):
                continue
            if c < lo or c > hi:
                return 0.0
            s *= (c - lo) / (p - lo) if c < p else (hi - c) / (hi - p)
        else:
            if c == 0 or c < min(0, p) or c > max(0, p):
                return 0.0
            s *= c / p
    return s


def _packed_points(r: _Reader, o: int, n_pts: int):
    """(point numbers or None for all, next offset)."""
    n = r.u8(o)
    o += 1
    if n & 0x80:
        n = ((n & 0x7F) << 8) | r.u8(o)
        o += 1
    if n == 0:
        return None, o
    pts, last = [], 0
    while len(pts) < n:
        c = r.u8(o)
        o += 1
        run = (c & 0x7F) + 1
        for _ in range(run):
            if c & 0x80:
                last += r.u16(o)
                o += 2
            else:
                last += r.u8(o)
                o += 1
            pts.append(last)
    return pts[:n], o


def _packed_deltas(r: _Reader, o: int, n: int):
    out = []
    while len(out) < n:
        c = r.u8(o)
        o += 1
        run = (c & 0x3F) + 1
        if c & 0x80:
            out.extend([0] * run)
        elif c & 0x40:
            out.extend(struct.unpack_from(">%dh" % run, r.d, o))
            o += 2 * run
        else:
            out.extend(struct.unpack_from(">%db" % run, r.d, o))
            o += run
    return out[:n], o


def _iup(pts: np.ndarray, d: np.ndarray, touched: np.ndarray,
         ends: List[int]) -> np.ndarray:
    """gvar's interpolation of untouched points, contour by contour."""
    d = d.copy()
    start = 0
    for end in ends:
        idx = np.arange(start, end + 1)
        t = idx[touched[idx]]
        start = end + 1
        if len(t) == 0 or len(t) == len(idx):
            continue
        if len(t) == 1:
            u = idx[~touched[idx]]
            d[u] = d[t[0]]
            continue
        for axis in range(2):
            for j in range(len(t)):
                a, b = t[j], t[(j + 1) % len(t)]
                # untouched points strictly between a and b (cyclically)
                if b > a:
                    between = np.arange(a + 1, b)
                else:
                    between = np.concatenate([np.arange(a + 1, end + 1),
                                              np.arange(idx[0], b)])
                if len(between) == 0:
                    continue
                ca, cb = pts[a, axis], pts[b, axis]
                da, db = d[a, axis], d[b, axis]
                if ca > cb:
                    ca, cb, da, db = cb, ca, db, da
                c = pts[between, axis]
                if ca == cb:
                    v = np.full(len(c), da if da == db else 0.0)
                else:
                    v = np.where(c <= ca, da, np.where(
                        c >= cb, db, da + (c - ca) * ((db - da) / (cb - ca))))
                d[between, axis] = v
    return d


# --- outlines to coverage ------------------------------------------------

def _shape(pts: np.ndarray, on: np.ndarray, ends: Sequence[int]):
    """stb_truetype's vertex list of a TrueType outline of integer points:
    per contour a start point and segments (x, y, cx, cy, is_curve), an
    on-curve point implied midway between two off-curve ones ((a + b) >> 1,
    as stb_truetype takes it)."""
    out = []
    start = 0
    for end in ends:
        p, o = pts[start:end + 1], on[start:end + 1]
        start = end + 1
        n = len(p)
        if n == 0:
            continue
        segs = []
        i = 0
        if not o[0]:
            scx, scy = p[0]
            if n > 1 and not o[1]:
                sx, sy = np.floor((p[0] + p[1]) / 2)
            elif n > 1:
                sx, sy = p[1]
                i = 1
            else:
                sx, sy = p[0]
        else:
            sx, sy = p[0]
        was_off = False
        cx = cy = 0.0
        for k in range(i + 1, n):
            x, y = p[k]
            if not o[k]:
                if was_off:
                    segs.append((math.floor((cx + x) / 2), math.floor((cy + y) / 2),
                                 cx, cy, True))
                cx, cy = x, y
                was_off = True
            else:
                segs.append((x, y, cx, cy, True) if was_off
                            else (x, y, 0.0, 0.0, False))
                was_off = False
        if not o[0]:
            if was_off:
                segs.append((math.floor((cx + scx) / 2),
                             math.floor((cy + scy) / 2), cx, cy, True))
            segs.append((sx, sy, scx, scy, True))
        else:
            segs.append((sx, sy, cx, cy, True) if was_off
                        else (sx, sy, 0.0, 0.0, False))
        out.append(((sx, sy), segs))
    return out


def _tesselate(out: list, x0, y0, x1, y1, x2, y2, flat2: float, n: int):
    """stb_truetype's recursive subdivision of a quadratic Bezier until
    its midpoint lies within sqrt(flat2) of the chord's midpoint."""
    mx = (x0 + 2 * x1 + x2) / 4
    my = (y0 + 2 * y1 + y2) / 4
    dx = (x0 + x2) / 2 - mx
    dy = (y0 + y2) / 2 - my
    if n > 16:
        return
    if dx * dx + dy * dy > flat2:
        _tesselate(out, x0, y0, (x0 + x1) / 2, (y0 + y1) / 2, mx, my,
                   flat2, n + 1)
        _tesselate(out, mx, my, (x1 + x2) / 2, (y1 + y2) / 2, x2, y2,
                   flat2, n + 1)
    else:
        out.append((x2, y2))


def _flatten(shape, flat2: float) -> List[np.ndarray]:
    """Each contour of `shape` as a closed polygon (M, 2) in font units."""
    polys = []
    for (sx, sy), segs in shape:
        pts = [(sx, sy)]
        px, py = sx, sy
        for x, y, cx, cy, curve in segs:
            if curve:
                _tesselate(pts, px, py, cx, cy, x, y, flat2, 0)
            else:
                pts.append((x, y))
            px, py = x, y
        polys.append(np.asarray(pts, np.float64))
    return polys


def _coverage(polys: Sequence[np.ndarray], w: int, h: int) -> np.ndarray:
    """(h, w) signed area of the polygons (pixel units, y down, pixel
    (r, c) the square [c, c+1] x [r, r+1]) inside each pixel: the exact
    area that stb_truetype's second rasterizer accumulates."""
    segs = []
    for p in polys:
        if len(p) < 2:
            continue
        a, b = np.roll(p, 1, axis=0), p
        segs.append(np.concatenate([a, b], 1))
    if not segs:
        return np.zeros((h, w))
    s = np.concatenate(segs)
    s = s[s[:, 1] != s[:, 3]]
    if len(s) == 0:
        return np.zeros((h, w))
    x0, y0, x1, y1 = s.T
    sign = np.where(y1 > y0, 1.0, -1.0)
    up = y1 < y0
    x0, y0, x1, y1 = (np.where(up, x1, x0), np.where(up, y1, y0),
                      np.where(up, x0, x1), np.where(up, y0, y1))
    # clip to the bitmap's rows and split each edge at every row boundary
    r0 = np.clip(np.floor(y0).astype(np.int64), 0, h)
    r1 = np.clip(np.ceil(y1).astype(np.int64), 0, h)
    n = np.maximum(r1 - r0, 0)
    e = np.repeat(np.arange(len(s)), n)
    row = r0[e] + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n))
    ya = np.maximum(row, y0[e])
    yb = np.minimum(row + 1, y1[e])
    keep = yb > ya
    e, row, ya, yb = e[keep], row[keep], ya[keep], yb[keep]
    slope = (x1[e] - x0[e]) / (y1[e] - y0[e])
    xa = x0[e] + (ya - y0[e]) * slope
    xb = x0[e] + (yb - y0[e]) * slope
    d = (yb - ya) * sign[e]
    xl, xr = np.minimum(xa, xb), np.maximum(xa, xb)
    # coverage of column c: d (G(c + 1) - G(c)), G(t) the mean of
    # max(t - x, 0) over the piece's x in [xl, xr]; d for c past xr
    c0 = np.floor(xl).astype(np.int64)
    c1 = np.floor(xr).astype(np.int64)
    wd = xr - xl
    acc = np.zeros((h, w + 2))
    part = np.zeros((h, w + 2))
    cs = np.clip(c0, -1, w) + 1
    np.add.at(acc, (row, cs), d)
    k = np.maximum(c1 - c0 + 1, 1)
    pe = np.repeat(np.arange(len(row)), k)
    col = c0[pe] + (np.arange(k.sum()) - np.repeat(np.cumsum(k) - k, k))

    def g(t, i):
        lo, hi, ww = xl[i], xr[i], wd[i]
        inside = np.where(ww > 0, (t - lo) ** 2 / (2 * np.where(ww > 0, ww,
                                                                  1)), 0.0)
        return np.where(t <= lo, 0.0, np.where(t >= hi, t - (lo + hi) / 2,
                                               inside))
    val = d[pe] * (g(col + 1.0, pe) - g(col.astype(np.float64), pe)) - d[pe]
    ok = (col >= -1) & (col < w)
    np.add.at(part, (row[pe][ok], col[ok] + 1), val[ok])
    cov = np.cumsum(acc, axis=1) + part
    return cov[:, 1:w + 1]


@functools.lru_cache(maxsize=None)
def load_font(name: str) -> Font:
    """A committed font by file name (`Rubik.ttf`, `Rubik-Italic.ttf`)."""
    return Font(FONT_DIR / name)


@functools.lru_cache(maxsize=8192)
def _glyph_bitmap(name: str, ch: str, size: int, weight: int):
    """(alpha (h, w) uint8, x offset, y offset from the baseline, pen
    advance in pixels) of one character."""
    font = load_font(name)
    g = font.glyph_index(ch)
    coords = font.normalized(wght=weight)
    pts, on, ends, adv = font.glyph(g, coords)
    s = size / font.ascent
    # the pen advances by whole pixels: the floored advance in font
    # units, scaled, rounded to 1/64 pixel, floored
    advance = int(math.floor(round(math.floor(adv) * s * 64) / 64))
    if len(pts) == 0:
        return np.zeros((0, 0), np.uint8), 0, 0, advance
    # stb_truetype keeps outline points as integers: the varied points
    # are floored, and implied on-curve points are midpoints shifted down
    shape = _shape(np.floor(pts), on, ends)
    polys = _flatten(shape, (0.35 / s) ** 2)
    allp = np.concatenate(polys)
    (xmin, ymin), (xmax, ymax) = allp.min(0), allp.max(0)
    ix0, iy0 = math.floor(xmin * s), math.floor(-ymax * s)
    ix1, iy1 = math.ceil(xmax * s), math.ceil(-ymin * s)
    px = [np.stack([p[:, 0] * s - ix0, -p[:, 1] * s - iy0], -1)
          for p in polys]
    cov = _coverage(px, ix1 - ix0, iy1 - iy0)
    alpha = np.minimum(np.abs(cov) * 255 + 0.5, 255).astype(np.uint8)
    return alpha, ix0, iy0, advance


def put_text(img: np.ndarray, text: str, org, face: int, scale: float,
             color=255, thickness: int = 1) -> np.ndarray:
    """`cv2.putText(img, text, org, face, scale, color, thickness,
    cv2.LINE_AA)` of cv2 5.0.0 on an (H, W) or (H, W, C) uint8 image, in
    place: each character's anti-aliased coverage a blends the pixel
    toward `color` (p + round((color - p) a / 255)), its pen advancing by
    whole pixels from `org` (the baseline's left end); text that runs off
    the image is clipped."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("put_text draws on an (H, W) or (H, W, C) uint8 "
                         "image")
    name, size, weight = hershey_to_truetype(int(face), float(scale),
                                             int(thickness))
    nch = 1 if img.ndim == 2 else img.shape[2]
    c = np.zeros(nch)
    given = np.atleast_1d(np.asarray(color, np.float64))[:nch]
    c[:len(given)] = given
    if img.ndim == 2:
        c = c[0]
    h, w = img.shape[:2]
    x, y = int(org[0]), int(org[1])
    for ch in text:
        alpha, ox, oy, adv = _glyph_bitmap(name, ch, size, weight)
        gh, gw = alpha.shape
        x0, y0 = x + ox, y + oy
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + gw, w), min(y0 + gh, h)
        if xb > xa and yb > ya:
            a = alpha[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.float64)
            if img.ndim == 3:
                a = a[..., None]
            dst = img[ya:yb, xa:xb].astype(np.float64)
            img[ya:yb, xa:xb] = np.clip(dst + np.rint((c - dst) * a / 255.0),
                                        0, 255)
        x += adv
    return img
