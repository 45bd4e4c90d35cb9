"""Image reading and resizing without cv2 or PIL, equal to cv2's:

* PNG: a decoder on the standard library's `zlib` plus numpy
  (`decode_png` of bytes, `read_png` of a file). It returns what
  `cv2.imread(path)` returns for the files it accepts: (H, W, 3) uint8 in
  BGR order. It accepts 8-bit, non-interlaced grayscale, RGB and RGBA
  files (gray is repeated into three channels, alpha is dropped, as cv2's
  default color mode does) with any of the five scanline filters, and
  raises `ValueError` for every other kind of PNG.
* JPEG: `decode_jpeg` of bytes and `read_jpeg` of a file give what cv2's
  libjpeg-turbo gives, pixel for pixel: sequential Huffman-coded 8-bit
  files (SOF0/SOF1), interleaved or single-component scans, restart
  markers, 1 or 3 components, any integer chroma sampling (4:4:4, 4:2:2,
  4:2:0, ...). The Huffman decoding runs in C++ (`csrc/jpeg_entropy.cpp`,
  built by g++ at first use, `utils/native.py`); the rest is libjpeg's
  integer pipeline vectorized in numpy: dequantization, the `JDCT_ISLOW`
  IDCT (`jidctint.c`), "fancy" triangle-filter chroma upsampling
  (`jdsample.c`), and the fixed-point YCbCr -> RGB tables (`jdcolor.c`).
  A gray read of a YCbCr file is its Y plane, as libjpeg gives it.
  Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files
  raise `ValueError` naming the kind; nothing falls back to cv2.
* `imread` dispatches on the file's signature (PNG, JPEG, else cv2,
  imported only then); `imread_gray` reads a PNG in gray as cv2 does
  (libpng's rgb-to-gray for color), a JPEG's gray plane, other formats
  by cv2; `resize` is cv2's `INTER_LINEAR` `cv2.resize`,
  fixed-point for uint8, in numpy.
* `load_textures`: the texture-crop loader of the rendered datasets
  (counterpart of `apps/render_depth_dataset.load_textures`).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from . import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> bytes a pixel at bit depth 8
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter_bytewise(kind: int, line: np.ndarray, prior: np.ndarray,
                       bpp: int) -> np.ndarray:
    """Filters 3 (average) and 4 (Paeth): each byte depends on the one
    `bpp` to its left after reconstruction, so they run byte by byte."""
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """Decode the bytes of an 8-bit, non-interlaced gray, RGB or RGBA PNG
    into an (H, W, 3) uint8 BGR array, as `cv2.imdecode(buf,
    cv2.IMREAD_COLOR)` does, or with `gray` into (H, W) as
    `cv2.IMREAD_GRAYSCALE` does: a gray file as it is, a color one through
    libpng's `png_set_rgb_to_gray` with cv2's weights, (9797 R + 19234 G +
    3737 B) >> 15, alpha dropped. Any other PNG, or bytes that are not
    one, raise ValueError."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("no IHDR or IDAT chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); only 8-bit non-interlaced "
            f"gray, RGB and RGBA are read")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_bytewise(kind, line, prior, bpp)
        else:
            raise ValueError(f"unknown filter type {kind} in row {y}")
        img[y] = cur
        prior = img[y]
    img = img.reshape(h, w, bpp)
    if bpp == 1:
        return img[..., 0] if gray else np.repeat(img, 3, axis=2)
    if gray:
        rgb = img[..., :3].astype(np.uint32)
        return ((9797 * rgb[..., 0] + 19234 * rgb[..., 1]
                 + 3737 * rgb[..., 2]) >> 15).astype(np.uint8)
    return np.ascontiguousarray(img[..., 2::-1])


def read_png(path: Union[str, Path], gray: bool = False) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray, RGB or RGBA PNG file into an
    (H, W, 3) uint8 BGR array, as `cv2.imread(path)` does, or with `gray`
    into (H, W) as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` does."""
    try:
        return decode_png(Path(path).read_bytes(), gray)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


JPEG_SOI = b"\xff\xd8"
_ENTROPY_SOURCE = native.PKG_DIR / "csrc" / "jpeg_entropy.cpp"
_ENTROPY_LOCK = threading.Lock()
_ENTROPY_LIB: Optional[ctypes.CDLL] = None

# frame markers this decoder refuses, by the kind they name
_UNSUPPORTED = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCC: "arithmetic-coded (DAC)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
# zigzag position -> natural (row-major) index
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _entropy_lib() -> ctypes.CDLL:
    global _ENTROPY_LIB
    with _ENTROPY_LOCK:
        if _ENTROPY_LIB is None:
            path = native.library_path(_ENTROPY_SOURCE, "jpeg_entropy")
            if not path.exists():
                native.build(path, _ENTROPY_SOURCE, "jpeg_entropy")
            lib = ctypes.CDLL(str(path))
            p = ctypes.c_void_p
            lib.jpeg_decode_scan.argtypes = [
                p, ctypes.c_int64, ctypes.c_int, p, p, p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, p]
            lib.jpeg_decode_scan.restype = ctypes.c_int
            _ENTROPY_LIB = lib
        return _ENTROPY_LIB


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """(marker code, index after it) of the first marker at or after
    `pos`, skipping fill bytes; (-1, len) at the end of the data."""
    i = data.find(b"\xff", pos)
    while 0 <= i < len(data) - 1 and data[i + 1] == 0xFF:
        i += 1
    if i < 0 or i >= len(data) - 1:
        return -1, len(data)
    return data[i + 1], i + 2


def _scan_end(data: bytes, pos: int) -> int:
    """Index of the marker that ends the entropy-coded segment starting at
    `pos`: the first 0xFF not followed by a stuffed 0x00, an RSTn or
    another 0xFF."""
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            return len(data)
        nxt = data[i + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7:
            pos = i + 2
        elif nxt == 0xFF:
            pos = i + 1
        else:
            return i


class _Frame:
    """The frame header (SOF0/SOF1) and the coefficient arrays its scans
    fill: for component i, `coefs[off[i]:off[i] + bh*bw]` holds its
    (bh, bw) blocks of 64 int16 in natural order."""

    def __init__(self, body: bytes):
        precision, self.h, self.w, n = struct.unpack(">BHHB", body[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported "
                             f"(8-bit samples only)")
        if self.h == 0 or self.w == 0:
            raise ValueError("JPEG with a height set by a DNL marker or an "
                             "empty frame is not supported")
        if n not in (1, 3):
            raise ValueError(f"{n}-component JPEG is not supported "
                             f"(gray or YCbCr only)")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.hs.append(hv >> 4 if n > 1 else 1)
            self.vs.append(hv & 15 if n > 1 else 1)
            self.tq.append(tq)
        if min(self.hs + self.vs) < 1:
            raise ValueError("JPEG with a zero sampling factor")
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # each component's own size (libjpeg's downsampled_width/height)
        self.cw = [-(-self.w * h // self.hmax) for h in self.hs]
        self.ch = [-(-self.h * v // self.vmax) for v in self.vs]
        if n == 1:
            self.bw = [-(-self.w // 8)]
            self.bh = [-(-self.h // 8)]
        else:
            self.bw = [self.mcux * h for h in self.hs]
            self.bh = [self.mcuy * v for v in self.vs]
        sizes = [bh * bw for bh, bw in zip(self.bh, self.bw)]
        self.off = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.coefs = np.zeros((self.off[-1], 64), np.int16)
        self.quant: List[Optional[np.ndarray]] = [None] * n
        self.scanned = [False] * n

    def blocks(self, i: int) -> np.ndarray:
        return self.coefs[self.off[i]:self.off[i + 1]].reshape(
            self.bh[i], self.bw[i], 64)


def _decode_coefficients(data: bytes) -> _Frame:
    """Parse the markers and entropy-decode every scan into the frame's
    coefficient arrays. Three components coded as RGB rather than YCbCr
    raise (libjpeg's rule: a JFIF marker means YCbCr, else an Adobe
    marker's transform, else the component ids 'R', 'G', 'B')."""
    if data[:2] != JPEG_SOI:
        raise ValueError("not a JPEG file")
    quant: Dict[int, np.ndarray] = {}
    bits = np.zeros((8, 16), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    have = set()
    restart = 0
    frame: Optional[_Frame] = None
    jfif, adobe = False, None
    pos = 2
    while True:
        marker, pos = _next_marker(data, pos)
        if marker in (-1, 0xD9):
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body, end = data[pos + 2:pos + length], pos + length
        if len(body) != length - 2:
            raise ValueError("truncated JPEG")
        if marker in _UNSUPPORTED:
            raise ValueError(f"{_UNSUPPORTED[marker]} JPEG is not supported "
                             f"(sequential Huffman-coded only)")
        if marker in (0xC0, 0xC1):
            frame = _Frame(body)
        elif marker == 0xC4:  # DHT: one or more tables
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(counts.sum(dtype=np.int64))
                if tc > 1 or th > 3 or n > 256:
                    raise ValueError("invalid Huffman table")
                bits[4 * tc + th] = counts
                vals[4 * tc + th] = 0
                vals[4 * tc + th, :n] = np.frombuffer(
                    body[i + 17:i + 17 + n], np.uint8)
                have.add(4 * tc + th)
                i += 17 + n
        elif marker == 0xDB:  # DQT: 8- or 16-bit tables in zigzag order
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                dt = ">u2" if pq else "u1"
                q = np.frombuffer(body[i + 1:i + 1 + 64 * (1 + pq)], dt)
                table = np.zeros(64, np.int32)
                table[_NATURAL] = q
                quant[tq] = table
                i += 1 + 64 * (1 + pq)
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            pos = _decode_scan(data, body, end, frame, quant, bits, vals,
                               have, restart)
            continue
        pos = end
    if frame is None or not all(frame.scanned):
        raise ValueError("JPEG without a frame or with a component no scan "
                         "codes")
    if len(frame.ids) == 3 and not jfif and (
            adobe == 0 if adobe is not None else frame.ids == [82, 71, 66]):
        raise ValueError("RGB-coded (non-YCbCr) JPEG is not supported")
    return frame


def _decode_scan(data, body, start, frame, quant, bits, vals, have,
                 restart) -> int:
    """Entropy-decode the scan whose header is `body` and whose data start
    at `start`; returns where its data end."""
    ns = body[0] if body else 0
    if not 1 <= ns <= 4 or len(body) < 4 + 2 * ns:
        raise ValueError("invalid JPEG scan header")
    params = np.zeros((ns, 8), np.int32)
    for j in range(ns):
        cid, tables = body[1 + 2 * j], body[2 + 2 * j]
        if cid not in frame.ids:
            raise ValueError(f"JPEG scan names unknown component {cid}")
        i = frame.ids.index(cid)
        td, ta = tables >> 4, tables & 15
        if td not in have or 4 + ta not in have:
            raise ValueError("JPEG scan uses an undefined Huffman table")
        if frame.tq[i] not in quant:
            raise ValueError("JPEG component uses an undefined quantization "
                             "table")
        frame.quant[i] = quant[frame.tq[i]].copy()  # latched at its scan
        frame.scanned[i] = True
        params[j] = (frame.hs[i], frame.vs[i], frame.bw[i],
                     -(-frame.cw[i] // 8), -(-frame.ch[i] // 8), td, ta,
                     frame.off[i])
    end = _scan_end(data, start)
    seg = np.frombuffer(data, np.uint8, end - start, start)
    rc = _entropy_lib().jpeg_decode_scan(
        seg.ctypes.data, end - start, ns, params.ctypes.data,
        bits.ctypes.data, vals.ctypes.data, frame.mcux, frame.mcuy, restart,
        frame.coefs.ctypes.data)
    if rc:
        raise ValueError("corrupt JPEG data" if rc == -1
                         else "invalid Huffman table")
    return end


# jidctint.c's constants: 13 fraction bits, PASS1_BITS 2
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _idct_1d(c):
    """One 8-point pass of `jpeg_idct_islow` over int32 arrays c[0..7] (the
    terms of frequency 0..7); returns the 8 outputs before descaling."""
    z1 = (c[2] + c[6]) * _F0541
    tmp2 = z1 - c[6] * _F1847
    tmp3 = z1 + c[2] * _F0765
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# libjpeg's post-IDCT range limit: index (value & 1023) -> sample, i.e.
# clamp(value + 128, 0, 255) for |value| < 512, wrapping beyond
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255),
                              np.zeros(384), np.arange(0, 128)]
                             ).astype(np.uint8)


def _idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantized coefficients in natural order, the (64,) table ->
    (N, 8, 8) uint8 samples, bit for bit libjpeg's `jpeg_idct_islow`."""
    b = (coefs.astype(np.int32) * quant).reshape(-1, 8, 8)
    cols = _idct_1d([b[:, k] for k in range(8)])    # each (N, 8 columns)
    ws = np.stack([_descale(x, _CONST_BITS - _PASS1_BITS) for x in cols], 1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # each (N, 8 rows)
    out = [_IDCT_LIMIT[_descale(x, _CONST_BITS + _PASS1_BITS + 3) & 1023]
           for x in rows]
    return np.stack(out, 2)


def _plane(frame: _Frame, i: int) -> np.ndarray:
    """Component i's samples at its own size (ch, cw), uint8."""
    bh, bw = frame.bh[i], frame.bw[i]
    px = _idct_islow(frame.blocks(i).reshape(-1, 64), frame.quant[i])
    px = px.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8,
                                                                 bw * 8)
    return px[:frame.ch[i], :frame.cw[i]]


def _fancy_h2(p: np.ndarray, bias_even: int, bias_odd: int,
              shift: int) -> np.ndarray:
    """Horizontal triangle filter doubling the width: out[2j] =
    (3 p[j] + p[j-1] + b0) >> s, out[2j+1] = (3 p[j] + p[j+1] + b1) >> s,
    the edges replicated (libjpeg's first and last column cases)."""
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + bias_even) >> shift
    out[:, 1::2] = (3 * p + right + bias_odd) >> shift
    return out


def _upsample(p: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a component plane by (fx, fy)
    (`jdsample.c`): the triangle filters for h2v1 and h2v2 (planes wider
    than 2) and h1v2, pixel replication otherwise."""
    w = p.shape[1]
    q = p.astype(np.int32)
    if (fx, fy) == (2, 1) and w > 2:
        return _fancy_h2(q, 1, 2, 2)
    if fy == 2 and fx in (1, 2) and (fx == 1 or w > 2):
        above = np.concatenate([q[:1], q[:-1]], 0)
        below = np.concatenate([q[1:], q[-1:]], 0)
        top, bot = 3 * q + above, 3 * q + below   # column sums
        if fx == 1:
            top, bot = (top + 1) >> 2, (bot + 2) >> 2
        else:
            top, bot = _fancy_h2(top, 8, 7, 4), _fancy_h2(bot, 8, 7, 4)
        out = np.empty((2 * q.shape[0], top.shape[1]), np.int32)
        out[0::2], out[1::2] = top, bot
        return out
    return np.repeat(np.repeat(q, fy, 0), fx, 1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)   # noqa: E731 (jdcolor.c FIX)
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    """Decode the bytes of a sequential Huffman-coded 8-bit JPEG into what
    `cv2.imdecode` gives: (H, W, 3) uint8 BGR (`IMREAD_COLOR`), or with
    `gray` the (H, W) uint8 of `IMREAD_GRAYSCALE`. Other kinds of JPEG,
    and bytes that are not one, raise ValueError."""
    frame = _decode_coefficients(bytes(data))
    h, w = frame.h, frame.w
    if len(frame.ids) == 1:
        y = _plane(frame, 0)[:h, :w]
        return y.copy() if gray else np.repeat(y[..., None], 3, 2)
    if gray and (frame.hs[0], frame.vs[0]) == (frame.hmax, frame.vmax):
        return np.ascontiguousarray(_plane(frame, 0)[:h, :w])
    planes = []
    for i in range(3):
        fx, fy = frame.hmax // frame.hs[i], frame.vmax // frame.vs[i]
        if fx * frame.hs[i] != frame.hmax or fy * frame.vs[i] != frame.vmax:
            raise ValueError("JPEG with fractional chroma sampling is not "
                             "supported")
        planes.append(_upsample(_plane(frame, i), fx, fy)[:h, :w])
    y, cb, cr = planes
    if gray:
        return y.astype(np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    out[..., 2] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
    out[..., 0] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def read_jpeg(path: Union[str, Path], gray: bool = False) -> np.ndarray:
    """`decode_jpeg` of a file: what `cv2.imread(path)` gives (BGR), or
    with `gray` what `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` gives."""
    try:
        return decode_jpeg(Path(path).read_bytes(), gray)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def imread(path: Union[str, Path]) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as `cv2.imread`: by the file's signature a PNG
    by `read_png`, a JPEG by `read_jpeg`, any other format by cv2,
    imported only then. A missing or unreadable file raises."""
    head = Path(path).read_bytes()[:8]
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == JPEG_SOI:
        return read_jpeg(path)
    import cv2
    im = cv2.imread(str(path))
    if im is None:
        raise FileNotFoundError(path)
    return im


def imread_gray(path: Union[str, Path, bytes]) -> Optional[np.ndarray]:
    """(H, W) uint8, as `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` (the JAX
    package's `train/megadepth.imread_gray`), of a file or of its bytes
    (`cv2.imdecode`): by the signature a PNG by `read_png` (gray as it
    is, color by libpng's rgb-to-gray), a JPEG by `read_jpeg`, any other
    format by cv2, imported only then. A PNG or JPEG this module refuses
    raises, naming it. A missing file gives None, as cv2 does."""
    if isinstance(path, (bytes, bytearray)):
        data, name = bytes(path), "<bytes>"
    else:
        p = Path(path)
        if not p.is_file():
            return None
        data, name = p.read_bytes(), str(p)
    try:
        if data[:8] == PNG_SIGNATURE:
            return decode_png(data, gray=True)
        if data[:2] == JPEG_SOI:
            return decode_jpeg(data, gray=True)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    import cv2
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


_COEF_BITS = 11   # cv2's INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, clamp: bool, dtype=np.float32):
    """cv2's INTER_LINEAR source index and fraction of every output
    position along one axis (`resize.cpp`: scale = 1 / (dst / src) in
    double, f = (d + 0.5) * scale - 0.5, rounded to `dtype`; float32 is
    its uint8 path). Along x (`clamp`), taps left of 0 or right of
    src - 1 sit on the edge with fraction 0."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(dtype)
    if clamp:
        lo, hi = s < 0, s >= src - 1
        s = np.where(lo, 0, np.where(hi, src - 1, s))
        f = np.where(lo | hi, dtype(0), f)
    return s, f


def _resize_area2(im: np.ndarray) -> np.ndarray:
    """cv2's INTER_AREA at exactly half size, which its INTER_LINEAR takes
    then: the mean of each 2x2 block, rounded for uint8."""
    h, w = im.shape[0] // 2, im.shape[1] // 2
    q = im[:2 * h, :2 * w]
    if im.dtype == np.uint8:
        q = q.astype(np.int32)
        s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
    return (s * np.float32(0.25)).astype(im.dtype)


def resize(im: np.ndarray, size_hw) -> np.ndarray:
    """`im` ((H, W) or (H, W, C), uint8 or float32) at (h, w) = `size_hw`,
    as `cv2.resize(im, (w, h))` gives it (one channel comes back 2-D) (INTER_LINEAR; INTER_AREA at an
    exact halving, as cv2 switches); unchanged when it has that size.
    uint8 runs cv2's fixed point: 11-bit weights, the horizontal pass in
    integers, the vertical pass as ((b0 (S0 >> 4)) >> 16 + (b1 (S1 >> 4))
    >> 16 + 2) >> 2."""
    oh, ow = (int(x) for x in size_hw)
    h, w = im.shape[:2]
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]    # cv2 returns one channel as (h, w)
    if (h, w) == (oh, ow):
        return im
    if im.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize takes uint8 or float32, not {im.dtype}")
    if (1.0 / (ow / w), 1.0 / (oh / h)) == (2.0, 2.0):
        return _resize_area2(im)
    dt = np.float32 if im.dtype == np.uint8 else np.float64
    sx, fx = _linear_taps(w, ow, True, dt)
    sy, fy = _linear_taps(h, oh, False, dt)
    x1 = np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    xs = (-1,) + (1,) * (im.ndim - 2)   # weights along x, then y
    ys = (-1,) + (1,) * (im.ndim - 1)
    if im.dtype == np.uint8:
        one = np.float32(1 << _COEF_BITS)
        ax0 = np.rint((np.float32(1) - fx) * one).astype(np.int32).reshape(xs)
        ax1 = np.rint(fx * one).astype(np.int32).reshape(xs)
        by0 = np.rint((np.float32(1) - fy) * one).astype(np.int32).reshape(ys)
        by1 = np.rint(fy * one).astype(np.int32).reshape(ys)
        q = im.astype(np.int32)
        s0 = (q[y0][:, sx] * ax0 + q[y0][:, x1] * ax1) >> 4
        s1 = (q[y1][:, sx] * ax0 + q[y1][:, x1] * ax1) >> 4
        out = (((by0 * s0) >> 16) + ((by1 * s1) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    # float32: cv2 (IPP here) weighs in more than float32 precision; this
    # runs in float64 and rounds once, within float32 rounding of cv2
    ax0, ax1 = (1 - fx).reshape(xs), fx.reshape(xs)
    by0, by1 = (1 - fy).reshape(ys), fy.reshape(ys)
    q = im.astype(np.float64)
    s0 = q[y0][:, sx] * ax0 + q[y0][:, x1] * ax1
    s1 = q[y1][:, sx] * ax0 + q[y1][:, x1] * ax1
    return (s0 * by0 + s1 * by1).astype(np.float32)

def load_textures(tex_dir: Union[str, Path], n: int, rng: np.random.Generator,
                  res: Tuple[int, int] = (256, 256)) -> List[np.ndarray]:
    """Random texture crops of at most `res` (w, h) from `n` PNGs of a pool
    directory, searched recursively in sorted order: the draws of
    `apps/render_depth_dataset.load_textures`, which takes `*.png` and
    `*.jpg` of the directory itself; on a flat directory of PNGs the two
    give the same crops from the same `rng`."""
    paths = sorted(str(p) for p in Path(tex_dir).rglob("*.png"))
    if not paths:
        raise FileNotFoundError(f"no PNG textures under {tex_dir}")
    out = []
    for p in rng.choice(paths, size=min(n, len(paths)), replace=False):
        im = read_png(p)
        h, w = im.shape[:2]
        ch, cw = min(res[1], h), min(res[0], w)
        y0 = rng.integers(0, h - ch + 1)
        x0 = rng.integers(0, w - cw + 1)
        out.append(np.ascontiguousarray(im[y0:y0 + ch, x0:x0 + cw]))
    return out
