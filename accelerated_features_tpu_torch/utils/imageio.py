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
  imported only then); `imread_if_image` reads a PNG or JPEG and gives
  None for any other file, never importing cv2, and `read_frames` reads
  the frames of a directory with it; `imread_gray` reads a PNG in gray
  as cv2 does (libpng's rgb-to-gray for color), a JPEG's gray plane,
  other formats by cv2; `resize` is cv2's `INTER_LINEAR` `cv2.resize`,
  fixed-point for uint8, in numpy, and its float32 `INTER_CUBIC` as
  cv2's default build computes it: Intel IPP's arithmetic (decoded by
  probes of cv2 5.0.0's IPP 2026.0.0 AVX-512 dispatch, whose bits it
  holds) for sources of at least 4 x 4 pixels with 1, 3 or 4 channels,
  OpenCV's own kernel for the rest, both to the bit.
* `write_png`: 8-bit gray or BGR arrays as PNG files (filter 0, zlib),
  which `read_png` and `cv2.imread` read back equal.
* `encode_jpeg` / `write_jpeg`: gray or BGR arrays as the JPEG bytes
  `cv2.imencode(".jpg", ...)` / `cv2.imwrite` give, byte for byte
  (baseline, 4:2:0, the standard Huffman tables; quality 95 by default);
  the Huffman coding is C++ beside the decoder's.
* `warp_perspective`: `cv2.warpPerspective(im, H, dsize)` with its
  defaults (`INTER_LINEAR`, `BORDER_CONSTANT` 0), equal to cv2's float32
  kernels (OpenCV >= 4.11) pixel for pixel.
* `load_textures`: the texture-crop loader of the rendered datasets
  (counterpart of `apps/render_depth_dataset.load_textures`; recursive
  over PNGs by default, the JAX loader's flat `*.png` + `*.jpg` with
  `recursive=False`).
"""

from __future__ import annotations

import ctypes
import glob
import os
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


def write_png(path: Union[str, Path], im: np.ndarray) -> None:
    """Write an (H, W) gray or (H, W, 3) BGR uint8 array as an 8-bit PNG
    (gray or RGB, every scanline filter 0, zlib level 6), as
    `cv2.imwrite` takes such arrays; `read_png` and `cv2.imread` read it
    back equal."""
    im = np.asarray(im)
    if im.dtype != np.uint8 or not (im.ndim == 2 or (im.ndim == 3
                                                     and im.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, not "
                         f"{im.shape} {im.dtype}")
    h, w = im.shape[:2]
    color = 0 if im.ndim == 2 else 2
    rows = (im if color == 0 else im[..., ::-1]).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    Path(path).write_bytes(
        PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b""))


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
            lib.jpeg_encode_scan.argtypes = [
                ctypes.c_int, p, p, p, p, ctypes.c_int, ctypes.c_int, p,
                ctypes.c_int64]
            lib.jpeg_encode_scan.restype = ctypes.c_int64
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


# ---- the JPEG writer -------------------------------------------------------
# T.81 Annex K's tables, as libjpeg's jcparam.c holds them: quantization in
# natural order, Huffman as 16 code counts then the symbols
_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66] + [99] * 38))
_STD_HUFFMAN = {  # (class, index) -> (bits, vals); class 0 DC, 1 AC
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
             bytes.fromhex(
                 "01020300041105122131410613516107227114328191a1082342b1c1"
                 "1552d1f02433627282090a161718191a25262728292a343536373839"
                 "3a434445464748494a535455565758595a636465666768696a737475"
                 "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                 "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                 "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
             bytes.fromhex(
                 "000102031104052131061241510761711322328108144291a1b1c109"
                 "233352f0156272d10a162434e125f11718191a262728292a35363738"
                 "393a434445464748494a535455565758595a636465666768696a7374"
                 "75767778797a82838485868788898a92939495969798999aa2a3a4a5"
                 "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6"
                 "d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _quant_table(which: int, quality: int) -> np.ndarray:
    """libjpeg's `jpeg_set_quality(cinfo, quality, TRUE)` table `which`
    (0 luminance, 1 chrominance), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((_STD_QUANT[which] * scale + 50) // 100, 1, 255)


def _reciprocals(divisors: np.ndarray):
    """libjpeg-turbo's `compute_reciprocal` of each divisor: (reciprocal,
    correction, shift) with which `quantize` divides by multiplying."""
    out = []
    for d in divisors.tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:            # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        out.append((fq, c, r))
    return tuple(np.array(x, np.int64) for x in zip(*out))


def _fdct_1d(d):
    """One 8-point pass of `jpeg_fdct_islow` over int64 arrays d[0..7];
    returns the outputs 0..7 before their scaling (0 and 4 still to be
    shifted, the rest to be descaled by the caller)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * _F0541
    even = (tmp10 + tmp11, z1 + tmp13 * _F0765, tmp10 - tmp11,
            z1 - tmp12 * _F1847)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return (even[0], tmp7 + z1 + z4, even[1], tmp6 + z2 + z3, even[2],
            tmp5 + z2 + z4, even[3], tmp4 + z1 + z3)


def _fdct_quantize(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """A padded (8 bh, 8 bw) uint8 plane -> its (bh, bw, 64) quantized
    coefficients in natural order, bit for bit libjpeg-turbo's
    `jpeg_fdct_islow` and `quantize` (divisors 8 q, by reciprocals)."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    b = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    b = b.astype(np.int64) - 128
    rows = _fdct_1d([b[:, :, k] for k in range(8)])   # each (N, 8 rows)
    ws = np.stack([x << _PASS1_BITS if k % 4 == 0 else
                   _descale(x, _CONST_BITS - _PASS1_BITS)
                   for k, x in enumerate(rows)], 2)
    cols = _fdct_1d([ws[:, k] for k in range(8)])     # each (N, 8 cols)
    coef = np.stack([_descale(x, _PASS1_BITS) if k % 4 == 0 else
                     _descale(x, _CONST_BITS + _PASS1_BITS)
                     for k, x in enumerate(cols)], 1).reshape(-1, 64)
    fq, c, r = _reciprocals(quant.astype(np.int64) << 3)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q).astype(np.int16).reshape(bh, bw, 64)


def _rgb_ycc_tables():
    i = np.arange(256, dtype=np.int64)
    fix = lambda v: int(v * 65536 + 0.5)   # noqa: E731 (jccolor.c FIX)
    half, offset = 1 << 15, 128 << 16
    return {"y": (fix(0.29900) * i, fix(0.58700) * i,
                  fix(0.11400) * i + half),
            "cb": (-fix(0.16874) * i, -fix(0.33126) * i,
                   fix(0.50000) * i + offset + half - 1),
            "cr": (fix(0.50000) * i + offset + half - 1,
                   -fix(0.41869) * i, -fix(0.08131) * i)}


_RGB_YCC = _rgb_ycc_tables()


def _pad_edge(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """p extended to (h, w) by repeating its last row and column."""
    return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])), mode="edge")


def _h2v2_downsample(p: np.ndarray) -> np.ndarray:
    """libjpeg's `h2v2_downsample` of an (even, even) plane: the 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along each output row, shifted by 2."""
    s = (p[0::2, 0::2].astype(np.int32) + p[0::2, 1::2] + p[1::2, 0::2]
         + p[1::2, 1::2])
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return ((s + bias) >> 2).astype(np.uint8)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(im: np.ndarray, quality: int = 95) -> bytes:
    """The bytes `cv2.imencode(".jpg", im, [cv2.IMWRITE_JPEG_QUALITY,
    quality])[1]` gives (libjpeg-turbo's defaults as OpenCV sets them),
    for (H, W, 3) uint8 BGR or (H, W) uint8 gray: a baseline JFIF file,
    the quality's scaled Annex K tables, 4:2:0 YCbCr (Y 2x2, Cb and Cr
    1x1) or one gray component, the standard Huffman tables, no restart
    interval. libjpeg-turbo's integer pipeline in numpy: the fixed-point
    RGB -> YCbCr tables (`jccolor.c`), edge replication to the MCU,
    `h2v2_downsample` (`jcsample.c`), the `jpeg_fdct_islow` DCT
    (`jfdctint.c`), quantization by reciprocals (`jcdctmgr.c`) and the
    padding blocks of the last MCU row and column (`jccoefct.c`); the
    Huffman coding runs in C++ (`csrc/jpeg_entropy.cpp`)."""
    im = np.asarray(im)
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]
    if im.dtype != np.uint8 or not (im.ndim == 2 or (im.ndim == 3 and
                                                     im.shape[2] == 3)) \
            or im.shape[0] == 0 or im.shape[1] == 0 \
            or max(im.shape[:2]) > 65535:
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) uint8 of "
                         f"at most 65535 a side, not {im.shape} {im.dtype}")
    h, w = im.shape[:2]
    quant = [_quant_table(0, quality), _quant_table(1, quality)]
    if im.ndim == 2:
        bh, bw = -(-h // 8), -(-w // 8)
        blocks = [_fdct_quantize(_pad_edge(im, 8 * bh, 8 * bw), quant[0])]
        comps = [(1, 0x11, 0)]                # (id, h x v, table)
        mcux, mcuy = bw, bh
    else:
        b, g, r = (im[..., k].astype(np.int64) for k in range(3))
        ycc = [((t[0][r] + t[1][g] + t[2][b]) >> 16).astype(np.uint8)
               for t in (_RGB_YCC["y"], _RGB_YCC["cb"], _RGB_YCC["cr"])]
        mcux, mcuy = -(-w // 16), -(-h // 16)
        # Y: edge-replicated to whole blocks; the blocks the 2x2 MCUs need
        # past them are padding blocks, all zero but the DC, which repeats
        # the block to the left (a padding column) or the MCU's last block
        # of the row above (a padding row)
        bh, bw = -(-h // 8), -(-w // 8)
        real = _fdct_quantize(_pad_edge(ycc[0], 8 * bh, 8 * bw), quant[0])
        y = np.zeros((2 * mcuy, 2 * mcux, 64), np.int16)
        y[:bh, :bw] = real
        if bw % 2:
            y[:bh, bw, 0] = y[:bh, bw - 1, 0]
        if bh % 2:
            y[bh, :, 0] = np.repeat(y[bh - 1, 1::2, 0], 2)
        blocks = [y]
        # Cb, Cr: rows to an even count and columns to whole MCUs by
        # replication, 2x2 averaged, then rows to whole blocks
        for p in ycc[1:]:
            p = _pad_edge(p, h + h % 2, 16 * mcux)
            blocks.append(_fdct_quantize(
                _pad_edge(_h2v2_downsample(p), 8 * mcuy, 8 * mcux),
                quant[1]))
        comps = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    coefs = np.ascontiguousarray(np.concatenate(
        [x.reshape(-1, 64) for x in blocks]))
    params, off = [], 0
    for (cid, hv, t), x in zip(comps, blocks):
        params.append((hv >> 4, hv & 15, x.shape[1], off, t, t))
        off += x.shape[0] * x.shape[1]
    params = np.array(params, np.int32)
    tables = [(0, 0), (0, 1), (1, 0), (1, 1)]
    bits = np.frombuffer(b"".join(_STD_HUFFMAN[k][0] for k in tables),
                         np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    for i, k in enumerate(tables):
        vals[i, :len(_STD_HUFFMAN[k][1])] = np.frombuffer(_STD_HUFFMAN[k][1],
                                                          np.uint8)
    cap = 512 * len(coefs) + 1024
    out = np.empty(cap, np.uint8)
    n = _entropy_lib().jpeg_encode_scan(
        len(comps), params.ctypes.data, coefs.ctypes.data, bits.ctypes.data,
        vals.ctypes.data, mcux, mcuy, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"JPEG entropy coding failed ({n})")
    used = sorted({t for _, _, t in comps})
    head = [b"\xff\xd8", _segment(0xE0, b"JFIF\0\x01\x01\x00"
                                  + struct.pack(">HH", 1, 1) + b"\0\0")]
    head += [_segment(0xDB, bytes([t]) + quant[t][_NATURAL].astype(
        np.uint8).tobytes()) for t in used]
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                         + b"".join(bytes(c) for c in comps)))
    head += [_segment(0xC4, bytes([cls << 4 | t]) + b"".join(
        _STD_HUFFMAN[(cls, t)])) for t in used for cls in (0, 1)]
    head.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, t << 4 | t]) for cid, _, t in comps) + b"\x00\x3f\x00"))
    return b"".join(head) + out[:n].tobytes() + b"\xff\xd9"


def write_jpeg(path: Union[str, Path], im: np.ndarray,
               quality: int = 95) -> None:
    """`encode_jpeg` into a file: the bytes `cv2.imwrite(path, im,
    [cv2.IMWRITE_JPEG_QUALITY, quality])` writes."""
    Path(path).write_bytes(encode_jpeg(im, quality))


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


def imread_if_image(path: Union[str, Path]) -> Optional[np.ndarray]:
    """`imread` of a PNG or JPEG (by its signature), and None for any
    other file, as the frame loops of the JAX package's apps skip a file
    on which `cv2.imread` gives None (`gt.npy`, a README). Never imports
    cv2; a PNG or JPEG this module refuses raises."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE or head[:2] == JPEG_SOI:
        return imread(path)
    return None


def read_frames(directory: Union[str, Path], max_frames: int
                ) -> List[Tuple[int, np.ndarray]]:
    """(position, BGR image) of the PNG and JPEG files among the first
    `max_frames` entries of `directory` in name order, the frame loop of
    the JAX package's SfM and SLAM apps: other entries (`gt.npy`, a
    README, a subdirectory) are skipped but keep their place in the
    count."""
    paths = sorted(glob.glob(os.path.join(str(directory), "*")))
    frames = [(i, imread_if_image(p)) for i, p in
              enumerate(paths[:max_frames]) if os.path.isfile(p)]
    return [(i, f) for i, f in frames if f is not None]


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


# the IPP resize's interior runs in stripes of this many output rows, so
# that a stripe's float64 temporaries stay in cache
_RESIZE_STRIPE = 64


def _ipp_cubic_taps(src: int, dst: int):
    """IPP's cubic taps along one axis: the 4 source indices (clamped:
    the border replicates) and float32 weights of every output position,
    and the range [lo, hi) of outputs whose 4 taps all lie inside the
    source. f = (d + 0.5) src / dst - 0.5 in float64; its fraction is
    rounded to float32 and taken as x = (frac + 1) - 1 in float32; each
    weight of the A = -0.75 kernel is evaluated from x in float64 and
    rounded to float32 on its own, the outer two in powers of their
    distance d (A d d d - 5 A d d + 8 A d - 4 A, left to right), which
    decides the last bit of the tiny ones."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    one = np.float32(1)
    x = (((f - s).astype(np.float32) + one) - one).astype(np.float64)
    a, u = -0.75, 1 - x

    def outer(d):
        return a * d * d * d - 5 * a * d * d + 8 * a * d - 4 * a

    w = np.stack([outer(x + 1), ((a + 2) * x - (a + 3)) * x * x + 1,
                  ((a + 2) * u - (a + 3)) * u * u + 1, outer(2 - x)], -1)
    s = s.astype(np.int64)
    inside = np.nonzero((s >= 1) & (s <= src - 3))[0]
    lo, hi = (int(inside[0]), int(inside[-1]) + 1) if inside.size else (0, 0)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None], 0, src - 1)
    return idx, w.astype(np.float32), lo, hi


def _resize_cubic_ipp(im: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2's INTER_CUBIC of a float32 (H, W) or (H, W, 3 | 4) image of at
    least 4 x 4 pixels as cv2's default build computes it, by Intel IPP
    (`ippiResizeCubic_32f`, replicated border), to the bit. Rows are
    interpolated first (taps and weights from `_ipp_cubic_taps`; s the
    taps, w their weights, p = s w rounded, fma one rounding).

    Outputs whose 16 taps all lie inside the source: each source row is
    (p0 + p1) + (p2 + p3) for one channel and fma(s1, w1, p2) +
    fma(s0, w0, p3) for 3 or 4; the rows are then summed as fma(s0, w0,
    p1) + fma(s2, w2, p3). Over the n values (outputs times channels) of
    an output row that these cover, the last n % 4 take (p0 + p2) +
    (p1 + p3) along the row (one channel) and fma(s1, w1, p0) + fma(s2,
    w2, p3) across the rows.

    Outputs with a clamped tap in either axis: each of the four source
    rows is a chain of fused multiply-adds over its taps, fma(s3, w3,
    fma(s2, w2, fma(s0, w0, p1))) for the middle two rows and fma(s3, w3,
    fma(s2, w2, fma(s1, w1, p0))) for the first and last; the rows are
    summed as (p0 + p2) + (p1 + p3)."""
    h, w = im.shape[:2]
    c = im.shape[2] if im.ndim == 3 else 1
    xi, xa, x0, x1 = _ipp_cubic_taps(w, ow)
    yi, ya, y0, y1 = _ipp_cubic_taps(h, oh)
    ch = (1,) * (im.ndim - 2)
    out = np.empty((oh, ow) + im.shape[2:], np.float32)

    def row_taps(rows, cols):
        """the 4 taps along x of outputs `cols` on source `rows`, and
        their weights"""
        src = im[rows]
        return ([src[:, xi[cols, k]] for k in range(4)],
                [xa[cols, k].reshape(1, -1, *ch) for k in range(4)])

    def border(ys, xs):
        """the outputs of rows `ys` and columns `xs` (index arrays), each
        with a clamped tap"""
        if not (ys.size and xs.size):
            return
        rows = np.unique(yi[ys])
        s, a = row_taps(rows, xs)
        mid = _fma(s[3], a[3], _fma(s[2], a[2], _fma(s[0], a[0], s[1] * a[1])))
        end = _fma(s[3], a[3], _fma(s[2], a[2], _fma(s[1], a[1], s[0] * a[0])))
        j = np.searchsorted(rows, yi[ys])
        b = ya[ys].reshape(-1, 4, 1, *ch)
        q = [(end if k in (0, 3) else mid)[j[:, k]] * b[:, k]
             for k in range(4)]
        out[np.ix_(ys, xs)] = (q[0] + q[2]) + (q[1] + q[3])

    border(np.r_[0:y0, y1:oh], np.arange(ow))   # above and below
    border(np.arange(y0, y1), np.r_[0:x0, x1:ow])  # left and right
    if y0 >= y1 or x0 >= x1:
        return out
    # the interior: its source rows along x, then stripes of output rows;
    # the last t values of each row take the tail's sums
    t = (x1 - x0) * c % 4
    r0 = int(yi[y0, 0])
    s, a = row_taps(slice(r0, int(yi[y1 - 1, 3]) + 1), slice(x0, x1))
    p = [s[k] * a[k] for k in range(4)]
    if c == 1:
        r = (p[0] + p[1]) + (p[2] + p[3])
        if t:
            r[:, -t:] = ((p[0] + p[2]) + (p[1] + p[3]))[:, -t:]
    else:
        r = _fma(s[1], a[1], p[2]) + _fma(s[0], a[0], p[3])
    k = -(-t // c)      # the pixels that hold the tail
    for lo in range(y0, y1, _RESIZE_STRIPE):
        hi = min(lo + _RESIZE_STRIPE, y1)
        rr = [r[yi[lo:hi, j] - r0] for j in range(4)]
        b = [ya[lo:hi, j].reshape(-1, 1, *ch) for j in range(4)]
        q3 = rr[3] * b[3]
        np.add(_fma(rr[0], b[0], rr[1] * b[1]), _fma(rr[2], b[2], q3),
               out=out[lo:hi, x0:x1])
        if t:
            tv = (_fma(rr[1][:, -k:], b[1], rr[0][:, -k:] * b[0])
                  + _fma(rr[2][:, -k:], b[2], q3[:, -k:]))
            blk = out[lo:hi, x1 - k:x1]
            flat = blk.reshape(hi - lo, -1)
            flat[:, -t:] = tv.reshape(hi - lo, -1)[:, -t:]
            blk[...] = flat.reshape(blk.shape)
    return out


def _cubic_taps(src: int, dst: int):
    """cv2's INTER_CUBIC taps along one axis (`resize.cpp`): the 4 source
    indices (clamped: the border replicates) and float32 weights of every
    output position; f = (d + 0.5) / (dst / src) - 0.5 rounded to float32,
    its fraction x weighted by `interpolateCubic` (A = -0.75) in float32,
    the last weight 1 minus the other three."""
    f32 = np.float32
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    x = fx - sx.astype(f32)
    a, one = f32(-0.75), f32(1)
    x1, y = x + one, one - x
    c0 = ((a * x1 - f32(5) * a) * x1 + f32(8) * a) * x1 - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * y - (a + f32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None], 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1)


def _resize_cubic(im: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2's INTER_CUBIC of a float32 (H, W) or (H, W, C) image, OpenCV's
    own kernel (`resizeGeneric_` with `HResizeCubic` / `VResizeCubic`) to
    the bit: rows first, each output the float32 sum
    ((s0 w0 + s1 w1) + s2 w2) + s3 w3 of its taps; then columns, whose
    sums run s0 w0 + (s1 w1 + (s2 w2 + s3 w3)) over each row's first
    4 * (n // 4) of its n = ow * C values (OpenCV's 4-lane vector loop)
    and left to right over the rest."""
    h, w = im.shape[:2]
    xi, xa = _cubic_taps(w, ow)
    yi, ya = _cubic_taps(h, oh)
    ch = (1,) * (im.ndim - 2)
    t = im[:, xi]                                   # (h, ow, 4, [C])
    a = xa.reshape(1, ow, 4, *ch)
    rows = ((t[:, :, 0] * a[:, :, 0] + t[:, :, 1] * a[:, :, 1])
            + t[:, :, 2] * a[:, :, 2]) + t[:, :, 3] * a[:, :, 3]
    r = rows[yi]                                    # (oh, 4, ow, [C])
    b = ya.reshape(oh, 4, 1, *ch)
    p = [r[:, j] * b[:, j] for j in range(4)]
    out = ((p[0] + p[1]) + p[2]) + p[3]
    flat = out.reshape(oh, -1)
    n4 = flat.shape[1] // 4 * 4
    vec = (p[0] + (p[1] + (p[2] + p[3]))).reshape(oh, -1)
    flat[:, :n4] = vec[:, :n4]
    return flat.reshape(out.shape)


def resize(im: np.ndarray, size_hw, interpolation: str = "linear"
           ) -> np.ndarray:
    """`im` ((H, W) or (H, W, C), uint8 or float32) at (h, w) = `size_hw`,
    as `cv2.resize(im, (w, h))` gives it (one channel comes back 2-D) (INTER_LINEAR; INTER_AREA at an
    exact halving, as cv2 switches); unchanged when it has that size.
    uint8 runs cv2's fixed point: 11-bit weights, the horizontal pass in
    integers, the vertical pass as ((b0 (S0 >> 4)) >> 16 + (b1 (S1 >> 4))
    >> 16 + 2) >> 2.

    `interpolation="cubic"` is `cv2.INTER_CUBIC` of a float32 image as
    cv2's default build (the PyPI wheels, with Intel IPP) computes it, to
    the bit, upsampling and downsampling alike. Like cv2, it hands
    sources of at least 4 x 4 pixels with 1, 3 or 4 channels to IPP's
    arithmetic (`_resize_cubic_ipp`) and every other source to OpenCV's
    own kernel (`_resize_cubic`), which is also what cv2 gives with
    `cv2.ipp.setUseIPP(False)`. IPP's bits depend on its CPU dispatch;
    those held are cv2 5.0.0's IPP 2026.0.0 AVX-512 (k0) ones."""
    oh, ow = (int(x) for x in size_hw)
    h, w = im.shape[:2]
    if im.ndim == 3 and im.shape[2] == 1:
        im = im[..., 0]    # cv2 returns one channel as (h, w)
    if (h, w) == (oh, ow):
        return im
    if interpolation == "cubic":
        if im.dtype != np.float32:
            raise ValueError(f"cubic resize takes float32, not {im.dtype}")
        if min(h, w) >= 4 and (im.ndim == 2 or im.shape[2] in (3, 4)):
            return _resize_cubic_ipp(im, oh, ow)
        return _resize_cubic(im, oh, ow)
    if interpolation != "linear":
        raise ValueError(f"interpolation is 'linear' or 'cubic', not "
                         f"{interpolation!r}")
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

# cv2's float32 warp kernels map 16 output pixels of a row at a time with
# one rounding of the row's terms, and the row's remaining pixels one by
# one with another (OpenCV's universal intrinsics at 16 float lanes)
_WARP_LANES = 16


def _invert3(m: np.ndarray) -> np.ndarray:
    """cv::invert of a 3x3 float64 matrix (DECOMP_LU takes the adjugate
    over the determinant at this size), its 9 entries row-major."""
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    if det == 0:
        return np.zeros(9)
    d = 1.0 / det
    return np.array([
        (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * d,
        (m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]) * d,
        (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * d,
        (m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]) * d,
        (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * d,
        (m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]) * d,
        (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * d,
        (m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]) * d,
        (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * d])


_F32_TINY = np.float32(2.0 ** -126)    # float32's smallest normal


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to a's dtype (float32 or float64), as a
    fused multiply-add. The product must be exact in the wider type:
    float64 holds any float32 product, numpy's long double (64 mantissa
    bits or more) a float64 times a short constant such as a blur tap.
    The sum is taken there rounded to odd (TwoSum's error decides the
    last bit), and rounding that to a's dtype is then the correctly
    rounded result.

    For float32 the plain float64 sum, rounded to float32, is already
    that result unless it lies on a float32 halfway point (float64's own
    rounding may then have decided the tie) or below float32's normal
    range; only those elements take the round-to-odd path."""
    a = np.asarray(a)
    if a.dtype != np.float32:
        return _fma_odd(a, b, c)
    s = np.multiply(a, b, dtype=np.float64)
    if np.broadcast_shapes(s.shape, np.shape(c)) == s.shape:
        np.add(s, c, out=s)
    else:
        s = s + c
    out = s.astype(np.float32)
    tie = (s.view(np.int64) & ((1 << 29) - 1)) == 1 << 28
    mag = np.abs(out)
    if mag.min(initial=np.inf) <= _F32_TINY:
        tie |= (mag <= _F32_TINY) & (s != 0)
    if tie.any():
        a, b, c = np.broadcast_arrays(a, b, c)
        out[tie] = _fma_odd(a[tie], b[tie], c[tie])
    return out


def _fma_odd(a, b, c) -> np.ndarray:
    """`_fma` by a sum rounded to odd in the wider type."""
    wide = np.float64 if a.dtype == np.float32 else np.longdouble
    nmant = np.finfo(wide).nmant
    if wide is np.longdouble and nmant < 63:
        raise RuntimeError("a float64 fused multiply-add needs a long "
                           "double of at least 64 mantissa bits")
    p = a.astype(wide) * np.asarray(b, wide)
    c = np.asarray(c, wide)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if wide is np.float64:     # the last bit of the significand
        even = (s.view(np.int64) & 1) == 0
    else:
        even = np.fmod(np.frexp(s)[0] * wide(2.0) ** (nmant + 1), 2) == 0
    fix = np.nonzero((err != 0) & even)
    s[fix] = np.nextafter(s[fix], np.where(err[fix] > 0, wide(np.inf),
                                           wide(-np.inf)))
    return s.astype(a.dtype)


def warp_perspective(im: np.ndarray, H: np.ndarray,
                     dsize: Tuple[int, int]) -> np.ndarray:
    """`cv2.warpPerspective(im, H, dsize)` with its defaults: output pixel
    (x, y) samples `im` at H^-1 (x, y) by `INTER_LINEAR`, taps outside the
    image read 0 (`BORDER_CONSTANT`), each tap on its own. `im`: (H, W),
    or (H, W, C) with C in 1, 3, 4, uint8 or float32; one channel comes
    back 2-D, as cv2 gives it; `dsize` is (width, height).

    The arithmetic is that of cv2's float32 kernels, to the bit: H is
    inverted in float64 (`cv::invert`) and rounded to float32; a row's
    terms y M1 + M2, y M4 + M5 and y M7 + M8 are rounded once each, and
    each pixel's x M0 + that term is one fused multiply-add, except for
    the row's last width % 16 pixels, which take (x M0 + y M1) + M2 with
    the first product fused; x = X / W; the bilinear weights are the
    float32 fractions of x and y, and the taps are blended by three fused
    multiply-adds (p00 + a (p01 - p00), then along y); uint8 rounds half
    to even and saturates."""
    if im.dtype not in (np.uint8, np.float32):
        raise ValueError(f"warp_perspective takes uint8 or float32, not "
                         f"{im.dtype}")
    src = im if im.ndim == 3 else im[..., None]
    if im.ndim not in (2, 3) or src.shape[2] not in (1, 3, 4):
        raise ValueError(f"warp_perspective takes (H, W) or (H, W, 1|3|4) "
                         f"images, not {im.shape}")
    w, h = (int(v) for v in dsize)
    m = _invert3(np.asarray(H, np.float64).reshape(3, 3)).astype(np.float32)
    f32 = np.float32
    y = np.arange(h, dtype=f32)[:, None]
    x = np.arange(w, dtype=f32)[None, :]
    x0 = (w // _WARP_LANES) * _WARP_LANES

    def mapped(a, b, c):
        out = _fma(x, m[a], (y * m[b]).astype(f32) + m[c])
        out[:, x0:] = _fma(x[:, x0:], m[a], (y * m[b]).astype(f32)) + m[c]
        return out
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        den = mapped(6, 7, 8)
        sx, sy = mapped(0, 1, 2) / den, mapped(3, 4, 5) / den
        # far off the image (or W = 0) every tap is a border tap
        inside = (np.abs(sx) < 1 << 24) & (np.abs(sy) < 1 << 24)
    sx, sy = np.where(inside, sx, f32(-2)), np.where(inside, sy, f32(-2))
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    # a zero frame around the image: a tap off the image lands on it
    sh, sw, ch = src.shape
    pad = np.zeros((sh + 2, sw + 2, ch), f32)
    pad[1:-1, 1:-1] = src
    pad = pad.reshape(-1, ch)
    ix = np.clip(fx.astype(np.int64) + 1, 0, sw + 1)
    ix1 = np.clip(fx.astype(np.int64) + 2, 0, sw + 1)
    row0 = np.clip(fy.astype(np.int64) + 1, 0, sh + 1) * (sw + 2)
    row1 = np.clip(fy.astype(np.int64) + 2, 0, sh + 1) * (sw + 2)
    p00, p01 = pad[row0 + ix], pad[row0 + ix1]
    p10, p11 = pad[row1 + ix], pad[row1 + ix1]
    v0 = _fma(ax, p01 - p00, p00)
    v1 = _fma(ax, p11 - p10, p10)
    out = _fma(ay, v1 - v0, v0)
    if im.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[..., 0] if ch == 1 else out


def load_textures(tex_dir: Union[str, Path], n: int, rng: np.random.Generator,
                  res: Tuple[int, int] = (256, 256),
                  recursive: bool = True) -> List[np.ndarray]:
    """Random texture crops of at most `res` (w, h) from `n` images of a
    pool directory, in sorted order, with the draws of the JAX package's
    `apps/render_depth_dataset.load_textures`. By default the PNGs under
    `tex_dir` are searched recursively (the port's SLAM and training
    sources); with `recursive=False` the pool is `*.png` and `*.jpg` of
    the directory itself, as the JAX loader takes it. Either way a file
    that is no PNG or JPEG is skipped, as cv2.imread's None is there; on a
    flat directory of PNGs the two give the same crops from the same
    `rng`."""
    if recursive:
        paths = sorted(str(p) for p in Path(tex_dir).rglob("*.png"))
    else:
        paths = sorted(glob.glob(os.path.join(str(tex_dir), "*.png"))
                       + glob.glob(os.path.join(str(tex_dir), "*.jpg")))
    if not paths:
        raise FileNotFoundError(f"no textures in {tex_dir}")
    out = []
    for p in rng.choice(paths, size=min(n, len(paths)), replace=False):
        im = imread_if_image(p)
        if im is None:
            continue
        h, w = im.shape[:2]
        ch, cw = min(res[1], h), min(res[0], w)
        y0 = rng.integers(0, h - ch + 1)
        x0 = rng.integers(0, w - cw + 1)
        out.append(np.ascontiguousarray(im[y0:y0 + ch, x0:x0 + cw]))
    if not out:
        raise RuntimeError("no readable textures")
    return out
