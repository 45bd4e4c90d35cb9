"""The port's cv2-free PNG reader (`utils/imageio.read_png`) against
`cv2.imread`, and its texture loader against the JAX package's
`apps/render_depth_dataset.load_textures`, on the CPU.

`read_png` must equal `cv2.imread` under `np.array_equal` on every PNG of
the committed holdout and on PNGs written here with `zlib`, one for each
scanline filter and pixel format it accepts; the formats it does not
accept must raise."""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from accelerated_features_tpu_torch.utils.imageio import (imread,
                                                          imread_gray,
                                                          load_textures,
                                                          read_png, resize)

ROOT = Path(__file__).resolve().parents[1]
HOLDOUT = ROOT / "artifacts" / "rendered_pose_holdout" / "MegaDepth_v1"
HOLDOUT_PNGS = sorted(HOLDOUT.rglob("*.png"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prior, bpp):
    """PNG scanline filter `kind` applied to one row of bytes."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _write_png(path, pixels, color, filters, depth=8, interlace=0):
    """Write `pixels` (h, w, channels) uint8 as a PNG of `color` type,
    row y filtered by filters[y % len(filters)]."""
    h, w = pixels.shape[:2]
    bpp = pixels.shape[2] if pixels.ndim == 3 else 1
    rows, prior = [], bytes(w * bpp)
    for y in range(h):
        row = pixels[y].tobytes()
        kind = filters[y % len(filters)]
        rows.append(bytes([kind]) + _filter_row(kind, row, prior, bpp))
        prior = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
        + _chunk(b"IEND", b""))


@pytest.mark.parametrize("path", HOLDOUT_PNGS,
                         ids=[str(p.relative_to(HOLDOUT))
                              for p in HOLDOUT_PNGS])
def test_read_png_equals_cv2_on_the_holdout(path):
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (608, 800, 3)
    assert np.array_equal(got, cv2.imread(str(path)))


def test_holdout_has_its_sixty_pngs():
    assert len(HOLDOUT_PNGS) == 60


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (6, 4)],
                         ids=["gray", "rgb", "rgba"])
def test_read_png_equals_cv2_for_every_filter(tmp_path, filt, color,
                                              channels):
    rng = np.random.default_rng(10 * filt + color)
    pixels = rng.integers(0, 256, (23, 37, channels), dtype=np.uint8)
    pixels[5:9] = 255       # wrap-around of every predictor
    pixels[12:14, :, :] = 0
    path = tmp_path / "x.png"
    _write_png(path, pixels if channels > 1 else pixels[..., 0], color,
               [filt])
    ref = cv2.imread(str(path))
    assert ref is not None and ref.shape == (23, 37, 3)
    assert np.array_equal(read_png(path), ref)


def test_read_png_mixed_filters_equal_cv2(tmp_path):
    pixels = np.random.default_rng(7).integers(0, 256, (40, 31, 3),
                                               dtype=np.uint8)
    path = tmp_path / "mixed.png"
    _write_png(path, pixels, 2, [4, 0, 3, 1, 2, 4, 4, 3])
    assert np.array_equal(read_png(path), cv2.imread(str(path)))
    # RGB in the file, BGR out, as cv2
    assert np.array_equal(read_png(path), pixels[..., ::-1])


@pytest.mark.parametrize("kind", ["16-bit", "interlaced", "palette",
                                  "not a png"])
def test_read_png_rejects_what_it_cannot_read(tmp_path, kind):
    path = tmp_path / "bad.png"
    pixels = np.zeros((4, 4, 3), np.uint8)
    if kind == "16-bit":
        _write_png(path, pixels, 2, [0], depth=16)
    elif kind == "interlaced":
        _write_png(path, pixels, 2, [0], interlace=1)
    elif kind == "palette":
        _write_png(path, pixels[..., 0], 3, [0])
    else:
        path.write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError):
        read_png(path)


def test_load_textures_gives_the_jax_crops(tmp_path):
    from apps.render_depth_dataset import load_textures as jax_load
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(90, 120), (300, 260), (64, 64), (200, 90),
                                (128, 300), (77, 77)]):
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"tex_{i}.png"), im)
    for res in ((256, 256), (64, 48)):
        r_jax, r_port = np.random.default_rng(5), np.random.default_rng(5)
        ref = jax_load(str(tmp_path), 4, r_jax, res)
        got = load_textures(tmp_path, 4, r_port, res)
        assert len(got) == len(ref) == 4
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert r_jax.random() == r_port.random()  # the same draws


def test_load_textures_searches_the_holdout_recursively():
    got = load_textures(HOLDOUT, 16, np.random.default_rng(3))
    assert len(got) == 16
    assert all(t.shape == (256, 256, 3) and t.dtype == np.uint8 for t in got)


def test_png_eval_runs_without_cv2(monkeypatch, tmp_path):
    """With cv2 unimportable, `imread` and `resize` serve PNGs at their own
    size and the holdout pose eval runs one pair; a format that is neither
    PNG nor JPEG needs cv2."""
    from accelerated_features_tpu_torch.eval import megadepth1500 as md
    path = HOLDOUT_PNGS[0]
    ref = cv2.imread(str(path))
    cv2.imwrite(str(tmp_path / "x.bmp"), ref[:8, :8])
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    im = imread(path)
    assert np.array_equal(im, ref) and resize(im, (608, 800)) is im
    with pytest.raises(ImportError):
        imread(tmp_path / "x.bmp")
    summary = md.run_benchmark(
        md.make_matcher("xfeat", 256, device="cpu"), str(HOLDOUT.parent),
        str(HOLDOUT.parent / "rendered_pose_pairs.json"), limit=1,
        progress=False)
    assert summary["n_pairs"] == 1 and summary["mean_matches"] > 20


def test_resize_equals_cv2_resize():
    """The eval's resize to a stored (h, w) is cv2's bilinear resize."""
    im = read_png(HOLDOUT_PNGS[1])
    got = resize(im, (480, 640))
    assert got.shape == (480, 640, 3)
    assert np.array_equal(got, cv2.resize(im, (640, 480)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("color,channels", [(0, 1), (2, 3), (6, 4)],
                         ids=["gray", "rgb", "rgba"])
def test_imread_gray_png_equals_cv2(tmp_path, seed, color, channels):
    """`imread_gray` of a PNG without cv2: a gray file as it is, a color
    one through libpng's rgb-to-gray (cv2's weights, truncated), on a
    seeded grid of sizes and of all five scanline filters."""
    rng = np.random.default_rng(100 * seed + color)
    for filt in range(5):
        h, w = (int(x) for x in rng.integers(1, 240, 2))
        pixels = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        pixels[: h // 3, :, :] = pixels[: h // 3, :, :1]  # gray-valued rows
        path = tmp_path / f"{filt}.png"
        _write_png(path, pixels if channels > 1 else pixels[..., 0], color,
                   [filt, (filt + 2) % 5])
        ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = imread_gray(path)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        assert np.array_equal(got, ref), (filt, h, w)
        assert np.array_equal(imread_gray(path.read_bytes()), ref)


def test_imread_gray_of_cv2_written_pngs_and_the_holdout(tmp_path):
    im = np.random.default_rng(5).integers(0, 256, (197, 231, 3),
                                           dtype=np.uint8)
    path = tmp_path / "cv2.png"
    cv2.imwrite(str(path), im)
    assert np.array_equal(imread_gray(path),
                          cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    for p in HOLDOUT_PNGS[:3]:
        assert np.array_equal(imread_gray(p),
                              cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))
    assert imread_gray(tmp_path / "missing.png") is None


def test_imread_gray_refuses_a_png_it_cannot_read(tmp_path):
    path = tmp_path / "p16.png"
    _write_png(path, np.zeros((4, 4, 3), np.uint8), 2, [0], depth=16)
    with pytest.raises(ValueError, match="p16.png"):
        imread_gray(path)
