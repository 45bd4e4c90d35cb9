"""Image reading without cv2 or PIL: a PNG decoder on the standard
library's `zlib` plus numpy (`decode_png` of bytes, `read_png` of a
file), the eval's reader that uses it for PNGs and cv2 only for other
formats (`imread`, `resize`), and the texture-crop loader of the rendered
datasets (counterpart of `apps/render_depth_dataset.load_textures`).

`read_png` returns what `cv2.imread(path)` returns for the files it
accepts: (H, W, 3) uint8 in BGR order. It accepts 8-bit, non-interlaced
grayscale, RGB and RGBA files (gray is repeated into three channels, alpha
is dropped, as cv2's default color mode does) with any of the five scanline
filters, and raises `ValueError` for every other kind of PNG.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Tuple, Union

import numpy as np

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


def decode_png(data: bytes) -> np.ndarray:
    """Decode the bytes of an 8-bit, non-interlaced gray, RGB or RGBA PNG
    into an (H, W, 3) uint8 BGR array, as `cv2.imdecode(buf,
    cv2.IMREAD_COLOR)` does; any other PNG, or bytes that are not one,
    raise ValueError."""
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
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray, RGB or RGBA PNG file into an
    (H, W, 3) uint8 BGR array, as `cv2.imread(path)` does."""
    try:
        return decode_png(Path(path).read_bytes())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def imread(path: Union[str, Path]) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as `cv2.imread`: a PNG by `read_png`, any other
    format by cv2, imported only then. A missing or unreadable file
    raises."""
    if str(path).lower().endswith(".png"):
        return read_png(path)
    import cv2
    im = cv2.imread(str(path))
    if im is None:
        raise FileNotFoundError(path)
    return im


def resize(im: np.ndarray, size_hw) -> np.ndarray:
    """`im` at (h, w) = `size_hw` by cv2's bilinear resize (cv2 imported
    only here); unchanged when it already has that size."""
    if im.shape[:2] == tuple(int(x) for x in size_hw):
        return im
    import cv2
    return cv2.resize(im, (int(size_hw[1]), int(size_hw[0])))


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
