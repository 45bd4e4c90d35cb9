"""The port's `utils/draw` against cv2, pixel for pixel, and the float32
`INTER_CUBIC` of `utils/imageio.resize` against cv2's resize, on the CPU.

Every primitive is drawn by cv2 and by the port on the same copy of a
random float32 or float64 (H, W, 3) image or a uint8 (H, W) mask, from
seeded draws that put shapes partly or wholly off the image, repeat and
line up polygon points, size ellipses at `EllipseEx`'s step thresholds
(3, 10 and 15 px) and put thick lines across the borders; the two images
must be equal. `gaussian_blur` (k = 3, 5) must equal cv2's bit for bit.

The cubic resize equals cv2's default to the bit, upsampling and
downsampling, in 1, 3 and 4 channels: IPP's kernel for sources of at least
4 x 4 px (as cv2 5.0.0's IPP 2026.0.0 AVX-512 dispatch computes it; another
dispatch fails the test with its name), OpenCV's own kernel below that.
The own kernel (`imageio._resize_cubic`, which `resize` also takes for 2
channels) equals cv2 with `setUseIPP(False)` on every grid.
"""

import cv2
import numpy as np
import pytest

from accelerated_features_tpu_torch.utils import draw
from accelerated_features_tpu_torch.utils.imageio import _resize_cubic, resize

H, W = 72, 96
DTYPES = ["float32", "float64", "mask"]


@pytest.fixture
def ipp_off():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _canvas(rng, kind):
    if kind == "mask":
        img = (rng.random((H, W)) < 0.3).astype(np.uint8) * 90
        return img, (255.0,)
    img = rng.random((H, W, 3)).astype(kind)
    return img, tuple(float(c) for c in rng.random(3))


def _both(img, color, cv_fn, port_fn):
    a, b = img.copy(), img.copy()
    cv_fn(a, color)
    port_fn(b, color)
    return a, b


def _point(rng, lo=-40, hi=140):
    return int(rng.integers(lo, hi)), int(rng.integers(lo, hi))


@pytest.mark.parametrize("kind", DTYPES)
def test_fill_poly_equals_cv2(kind):
    rng = np.random.default_rng(10 + DTYPES.index(kind))
    for t in range(250):
        img, color = _canvas(rng, kind)
        k = int(rng.integers(1, 9))
        pts = rng.integers(-40, 140, (k, 2)).astype(np.int32)
        if t % 5 == 1 and k > 1:            # repeated points
            pts[int(rng.integers(1, k))] = pts[0]
        if t % 5 == 2:                      # collinear points
            d = rng.integers(-9, 10, 2)
            pts = (pts[:1] + np.arange(k)[:, None] * d).astype(np.int32)
        if t % 5 == 3:                      # inside the image
            pts = np.stack([rng.integers(0, W, k), rng.integers(0, H, k)],
                           -1).astype(np.int32)
        a, b = _both(img, color,
                     lambda m, c: cv2.fillPoly(m, [pts], c),
                     lambda m, c: draw.fill_poly(m, [pts], c))
        assert np.array_equal(a, b), (t, pts.tolist())


@pytest.mark.parametrize("kind", DTYPES)
def test_box_points_and_rotated_rectangles_equal_cv2(kind):
    rng = np.random.default_rng(20 + DTYPES.index(kind))
    for t in range(200):
        img, color = _canvas(rng, kind)
        x, y = _point(rng, -30, 120)
        s = int(rng.integers(6, 60))
        box = ((x, y), (s, s * float(rng.random()) + 3),
               float(rng.random() * 180))
        ref = cv2.boxPoints(box)
        got = draw.box_points(*box)
        assert got.dtype == np.float32 and np.array_equal(ref, got), box
        pts = got.astype(np.int32)
        a, b = _both(img, color,
                     lambda m, c: cv2.fillPoly(m, [pts], c),
                     lambda m, c: draw.fill_poly(m, [pts], c))
        assert np.array_equal(a, b), box


@pytest.mark.parametrize("kind", DTYPES)
def test_ellipse_equals_cv2(kind):
    rng = np.random.default_rng(30 + DTYPES.index(kind))
    # the largest axis at each side of the step thresholds, then random
    sizes = [0, 1, 2, 3, 4, 9, 10, 11, 14, 15, 16] + \
        [int(v) for v in rng.integers(0, 50, 150)]
    for t, s in enumerate(sizes):
        img, color = _canvas(rng, kind)
        c = _point(rng, -30, 120)
        axes = (s, max(3, int(s * float(rng.random()))))
        if t % 2:
            axes = axes[::-1]
        ang = float(rng.random() * 360 - 90)
        a, b = _both(img, color,
                     lambda m, col: cv2.ellipse(m, c, axes, ang, 0, 360,
                                                col, -1),
                     lambda m, col: draw.fill_ellipse(m, c, axes, ang, col))
        assert np.array_equal(a, b), (c, axes, ang)


@pytest.mark.parametrize("kind", DTYPES)
def test_rectangle_and_circle_equal_cv2(kind):
    rng = np.random.default_rng(40 + DTYPES.index(kind))
    for t in range(200):
        img, color = _canvas(rng, kind)
        p0, p1 = _point(rng), _point(rng)
        a, b = _both(img, color,
                     lambda m, c: cv2.rectangle(m, p0, p1, c, -1),
                     lambda m, c: draw.rectangle(m, p0, p1, c))
        assert np.array_equal(a, b), (p0, p1)
        r = int(rng.integers(0, 60))
        a, b = _both(img, color,
                     lambda m, c: cv2.circle(m, p0, r, c, -1),
                     lambda m, c: draw.circle(m, p0, r, c))
        assert np.array_equal(a, b), (p0, r)


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("kind", DTYPES)
def test_line_equals_cv2(kind, thickness):
    rng = np.random.default_rng(50 + 3 * DTYPES.index(kind) + thickness)
    for t in range(200):
        img, color = _canvas(rng, kind)
        if t % 4 == 0:      # along or across a border
            p0 = (int(rng.choice([-3, -1, 0, 1, W - 2, W - 1, W, W + 2])),
                  int(rng.integers(-5, H + 5)))
            p1 = (int(rng.integers(-5, W + 5)),
                  int(rng.choice([-2, 0, 1, H - 1, H, H + 3])))
        else:
            p0, p1 = _point(rng, -20, 115), _point(rng, -20, 115)
        a, b = _both(img, color,
                     lambda m, c: cv2.line(m, p0, p1, c, thickness),
                     lambda m, c: draw.line(m, p0, p1, c, thickness))
        assert np.array_equal(a, b), (p0, p1)


@pytest.mark.parametrize("kind", DTYPES)
def test_polylines_equal_cv2(kind):
    rng = np.random.default_rng(60 + DTYPES.index(kind))
    for _ in range(120):
        img, color = _canvas(rng, kind)
        pts = rng.integers(-20, 115, (4, 2)).astype(np.int32)
        th = int(rng.integers(1, 4))
        a, b = _both(img, color,
                     lambda m, c: cv2.polylines(m, [pts], True, c, th),
                     lambda m, c: draw.polylines(m, pts, c, th))
        assert np.array_equal(a, b), (pts.tolist(), th)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gaussian_blur_equals_cv2(dtype, k):
    rng = np.random.default_rng(70 + k)
    for shape in [(72, 96, 3), (608, 800, 3), (5, 7, 3), (33, 17, 3)]:
        img = rng.random(shape).astype(dtype)
        got = draw.gaussian_blur(img, k)
        assert got.dtype == img.dtype
        assert np.array_equal(cv2.GaussianBlur(img, (k, k), 0), got), shape


# the value-noise grids of the pool generator at 800x608 and 96x72, and
# a few others; the outputs it upsamples them to
GRIDS = [(2, 2), (2, 3), (3, 7), (4, 6), (9, 12), (18, 24), (19, 25),
         (38, 50), (76, 100), (152, 200)]
OUTS = [(608, 800), (72, 96), (37, 53)]
# the IPP dispatch whose bits `resize` holds (`cv2.ipp.getIppVersion()`)
IPP_HELD = "ippIP AVX-512F/CD/BW/DQ/VL (k0) 2026.0.0"
# sources the IPP test adds to GRIDS, with their own outputs; at
# (17, 201) -> (372, 199) two output rows take a weight of ~1e-6, whose
# last bit depends on how the kernel is evaluated
IPP_EXTRA = {(608, 800): [(1216, 1600)], (100, 100): [(100, 150)],
             (17, 201): [(372, 199)]}


@pytest.mark.parametrize("grid", GRIDS)
def test_cubic_resize_equals_cv2_own_kernel(ipp_off, grid):
    """OpenCV's own kernel: `resize` takes it for sources under 4 px a
    side, `_resize_cubic` is it for every source."""
    rng = np.random.default_rng(80)
    for c in (0, 3):
        g = rng.random(grid + ((c,) if c else ()), dtype=np.float32)
        for out in OUTS + [(grid[0] // 2 + 1, grid[1] // 2 + 1)]:
            ref = cv2.resize(g, out[::-1], interpolation=cv2.INTER_CUBIC)
            own = _resize_cubic(g, *out)
            assert own.dtype == np.float32 and own.shape == ref.shape
            assert np.array_equal(ref, own), (grid, c, out)
            if min(grid) < 4:
                assert np.array_equal(ref, resize(g, out, "cubic")), \
                    (grid, c, out)


@pytest.mark.parametrize("grid", GRIDS + list(IPP_EXTRA))
def test_cubic_resize_against_cv2_with_ipp(grid):
    """cv2's default, IPP for sources of at least 4 x 4 px: equal to the
    bit, upsampling and downsampling, in 1, 3 and 4 channels (2 channels:
    OpenCV's own kernel, which cv2 takes then), on random images and on
    images that are zero but every 5th pixel of every 5th row, where an
    output is one tap times its two weights and shows their every bit."""
    version = cv2.ipp.getIppVersion()
    assert cv2.ipp.useIPP() and version.startswith(IPP_HELD), (
        f"cv2 {cv2.__version__} runs IPP {version!r} "
        f"(on: {cv2.ipp.useIPP()}); resize holds the bits of {IPP_HELD!r}")
    rng = np.random.default_rng(81)
    outs = IPP_EXTRA.get(grid, OUTS + [(23, 31),
                                       (grid[0] // 2 + 1, grid[1] // 2 + 1)])
    for c in (0, 3, 4, 2):
        for out in outs:
            g = rng.random(grid + ((c,) if c else ()), dtype=np.float32)
            sparse = np.zeros_like(g)
            sparse[::5, ::5] = g[::5, ::5] - np.float32(0.5)
            for im in (g, sparse):
                ref = cv2.resize(im, out[::-1],
                                 interpolation=cv2.INTER_CUBIC)
                got = resize(im, out, "cubic")
                assert got.dtype == np.float32 and got.shape == ref.shape
                assert np.array_equal(ref, got), (grid, c, out)
