"""The port's `utils/text.put_text` against `cv2.putText` of cv2 5.0.0, on
the CPU.

cv2 5.0.0 draws its Hershey faces with the variable TrueType fonts built
into the library (Rubik, Rubik Italic); the port reads the same fonts from
`accelerated_features_tpu_torch/assets/fonts`. The draws are those of the
pool generator's text shapes: 6 characters from 33-126, every face 0-7, a
scale in [0.5, 3.0], a thickness 1-3, `LINE_AA`, on an 800x608 mask, with
origins that leave text partly off the mask on every side. The tolerance,
held for every mask:

- every pixel within 8 of cv2's (of 255), and at most 2 % of the inked
  pixels different at all;
- the IoU of `mask >= 128` at least 0.99;
- the ink's bounding box equal within 1 px;

and over all draws at most 0.1 % of the inked pixels different. (The
port measured at most 4 levels, and 0.02 % of the pixels, on these draws.)

The face/size/weight table is held to cv2's own `FontFace` drawing, and
the committed fonts to the gzip members of the installed `cv2.abi3.so` by
sha256. These tests need cv2 5.0.0 and skip with another version.
"""

import hashlib
import os
import zlib

import cv2
import numpy as np
import pytest

from accelerated_features_tpu_torch.utils.text import (FONT_DIR,
                                                       hershey_to_truetype,
                                                       put_text)

pytestmark = pytest.mark.skipif(
    cv2.__version__ != "5.0.0",
    reason=f"the text is held to cv2 5.0.0, not {cv2.__version__}")

H, W = 608, 800
N_DRAWS = 240
MAX_LEVEL, MAX_FRAC, MIN_IOU, MAX_BOX = 8, 0.02, 0.99, 1
MAX_TOTAL_FRAC = 0.001


def _draws(seed):
    rng = np.random.default_rng(seed)
    for _ in range(N_DRAWS):
        chars = "".join(chr(int(c)) for c in rng.integers(33, 127, 6))
        org = (int(rng.integers(-120, W)), int(rng.integers(-20, H + 60)))
        yield (chars, org, int(rng.integers(0, 8)),
               float(rng.uniform(0.5, 3.0)), int(rng.integers(1, 4)))


def _box(m):
    r, c = np.nonzero(m)
    return np.array([r.min(), r.max(), c.min(), c.max()])


@pytest.mark.parametrize("seed", [0, 1])
def test_put_text_matches_cv2_within_tolerance(seed):
    diff_total = ink_total = 0
    faces = set()
    for chars, org, face, scale, th in _draws(seed):
        a = np.zeros((H, W), np.uint8)
        b = np.zeros((H, W), np.uint8)
        cv2.putText(a, chars, org, face, scale, 255, th, cv2.LINE_AA)
        got = put_text(b, chars, org, face, scale, 255, th)
        assert got is b
        faces.add(face)
        d = np.abs(a.astype(np.int64) - b)
        ink = int(((a > 0) | (b > 0)).sum())
        n_diff = int((d > 0).sum())
        diff_total += n_diff
        ink_total += ink
        what = (chars, org, face, scale, th)
        assert d.max() <= MAX_LEVEL, what
        assert n_diff <= MAX_FRAC * ink + 1, what
        assert a.any() == b.any(), what
        if a.any():
            ia, ib = a >= 128, b >= 128
            if (ia | ib).any():
                assert (ia & ib).sum() / (ia | ib).sum() >= MIN_IOU, what
            assert np.abs(_box(a) - _box(b)).max() <= MAX_BOX, what
    assert faces == set(range(8))
    assert ink_total > 100_000
    assert diff_total <= MAX_TOTAL_FRAC * ink_total


def test_put_text_on_color_image_blends_like_cv2():
    """A BGR image under a colored label (register_demo's use): each
    channel blended toward the color by the glyph's coverage."""
    rng = np.random.default_rng(3)
    for face, th, color in [(0, 2, (255, 255, 255)), (3, 1, (30, 200, 120)),
                            (7, 3, (0, 0, 255))]:
        bg = rng.integers(0, 256, (120, 400, 3)).astype(np.uint8)
        a, b = bg.copy(), bg.copy()
        cv2.putText(a, "inliers: 57  fps: 9.8", (10, 60), face, 1.2, color,
                    th)
        put_text(b, "inliers: 57  fps: 9.8", (10, 60), face, 1.2, color, th)
        d = np.abs(a.astype(np.int64) - b)
        assert d.max() <= MAX_LEVEL
        assert (d > 0).sum() <= MAX_FRAC * (a != bg).any(-1).sum()


@pytest.mark.parametrize("face", range(8))
def test_face_table_equals_cv2_fontface_drawing(face):
    """cv2.putText(face, scale, thickness) draws exactly what cv2's
    FontFace API draws at the (font, size, weight) of the table."""
    rng = np.random.default_rng(face)
    name = "italic" if face >= 6 else "sans"
    for th in (1, 2, 3):
        for scale in rng.uniform(0.5, 3.0, 3):
            font, size, weight = hershey_to_truetype(face, float(scale), th)
            assert font == ("Rubik-Italic.ttf" if face >= 6
                            else "Rubik.ttf")
            a = np.zeros((200, 900), np.uint8)
            b = np.zeros((200, 900), np.uint8)
            cv2.putText(a, "Ag#x7!Wm", (10, 150), face, float(scale), 255,
                        th, cv2.LINE_AA)
            cv2.putText(b, "Ag#x7!Wm", (10, 150), (255,),
                        cv2.FontFace(name), size, weight)
            assert np.array_equal(a, b), (th, scale, size, weight)


def _gzip_members(blob: bytes):
    """The gzip members of a binary: {file name: unpacked bytes}."""
    out, i = {}, 0
    while True:
        i = blob.find(b"\x1f\x8b\x08\x08", i)
        if i < 0:
            return out
        end = blob.find(b"\x00", i + 10)
        name = blob[i + 10:end].decode("latin-1", "replace")
        if name.endswith(".ttf"):
            d = zlib.decompressobj(16 + zlib.MAX_WBITS)
            try:
                out[name] = d.decompress(blob[i:i + (1 << 24)])
            except zlib.error:
                pass
        i += 4


def test_committed_fonts_equal_the_fonts_inside_cv2():
    so = [f for f in os.listdir(os.path.dirname(cv2.__file__))
          if f.startswith("cv2") and f.endswith(".so")]
    assert so, "no cv2 shared library beside cv2/__init__.py"
    members = _gzip_members(
        open(os.path.join(os.path.dirname(cv2.__file__), so[0]), "rb").read())
    for name in ("Rubik.ttf", "Rubik-Italic.ttf"):
        committed = (FONT_DIR / name).read_bytes()
        assert hashlib.sha256(committed).hexdigest() == \
            hashlib.sha256(members[name]).hexdigest(), name
        assert committed[:4] == b"\x00\x01\x00\x00"
    notice = (FONT_DIR / "NOTICE").read_text()
    assert "SIL Open Font License, Version 1.1" in notice
    for name in ("Rubik.ttf", "Rubik-Italic.ttf"):
        assert hashlib.sha256((FONT_DIR / name).read_bytes()).hexdigest() \
            in notice
