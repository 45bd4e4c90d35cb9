"""Procedural image pool for offline synthetic training (counterpart of the
JAX package's `apps/make_synthetic_pool.py`), without cv2:

layered low-frequency gradients and value-noise texture, with polygons,
ellipses, lines and checker patches at random scales (style v1), and in
style v2 four background families, text glyphs, concentric rings, star
polygons, translucent shapes and a per-image gamma, contrast and blur.
The pool is where the offline data paths start (`render_depth_dataset
--textures`, `eval_synthetic --images <pool>_holdout`,
`train.run --synthetic_root_path`, `train.lighterglue_run
--synthetic_root_path`).

From the same `--seed` it makes the JAX app's draws, in the same order
and with the same calls, so the generator's state after N images is the
same, and draws with `utils/draw` (cv2's fills, lines and blur, pixel
for pixel), `utils/imageio.resize` (cv2's INTER_CUBIC as its default
build computes it, with Intel IPP), and `utils/text.put_text` (cv2
5.0.0's text). Style v1 writes the JAX app's PNGs pixel for pixel as
cv2 runs by default, and so does v2 but for its text, which is that of
cv2 5.0.0 within the tolerance of `tests/test_torch_text.py`. The PNGs
are written by `utils/imageio.write_png` (BGR arrays, as `cv2.imwrite`
takes them), the same names into <out> and <out>_holdout; `pool_digests`
hashes the pixels of a pool, which
`tests/fixtures/synthetic_pool_v1_s0_800x608.json` holds for the JAX
app's v1 pool of seed 0 (16 + 4 images at 800x608).

    python -m accelerated_features_tpu_torch.apps.make_synthetic_pool \\
        --out /tmp/synth_pool [--n 600] [--res 800x608] [--holdout 40] \\
        [--seed 0] [--style v2] [--prefix img]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..utils import draw
from ..utils.imageio import read_png, resize, write_png
from ..utils.text import put_text


def _value_noise(rng, h, w, octaves=4):
    """Multi-octave smoothed value noise in [0, 1] (cubic upsampling)."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - o + 1)), max(2, w >> (octaves - o + 1))
        g = rng.random((gh, gw), dtype=np.float32)
        out += amp * resize(g, (h, w), "cubic")
        total += amp
        amp *= 0.55
    out /= total
    return np.clip(out, 0, 1)


def make_image(rng, h, w):
    """Style v1: gradient + value noise, opaque polygons, rotated
    rectangles, ellipses, checker patches and lines."""
    # low-frequency color gradient background
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        a, b = rng.random(2)
        gx = np.linspace(a, b, w, dtype=np.float32)[None, :]
        c0, c1 = rng.random(2)
        gy = np.linspace(c0, c1, h, dtype=np.float32)[:, None]
        img[..., c] = 0.5 * gx + 0.5 * gy
    # texture layer
    tex = _value_noise(rng, h, w)
    img = 0.6 * img + 0.4 * tex[..., None] * rng.random(3)[None, None]

    # random opaque shapes (corners!)
    n_shapes = rng.integers(12, 40)
    for _ in range(n_shapes):
        color = rng.random(3).astype(float)
        kind = rng.integers(0, 4)
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(6, max(8, min(h, w) // 3)))
        if kind == 0:    # polygon
            k = rng.integers(3, 8)
            ang = np.sort(rng.random(k) * 2 * np.pi)
            r = s * (0.4 + 0.6 * rng.random(k))
            pts = np.stack([x + r * np.cos(ang), y + r * np.sin(ang)],
                           -1).astype(np.int32)
            draw.fill_poly(img, [pts], color)
        elif kind == 1:  # rotated rectangle
            box = draw.box_points((x, y), (s, s * rng.random() + 3),
                                  float(rng.random() * 180))
            draw.fill_poly(img, [box.astype(np.int32)], color)
        elif kind == 2:  # ellipse
            draw.fill_ellipse(img, (x, y),
                              (s, max(3, int(s * rng.random()))),
                              float(rng.random() * 180), color)
        else:            # checker patch
            cells = int(rng.integers(2, 6))
            cs = max(3, s // cells)
            for i in range(cells):
                for j in range(cells):
                    if (i + j) % 2 == 0:
                        x0, y0 = x + j * cs, y + i * cs
                        draw.rectangle(img, (x0, y0), (x0 + cs, y0 + cs),
                                       color)
    # thin lines
    for _ in range(int(rng.integers(4, 14))):
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        draw.line(img, p0, p1, rng.random(3).astype(float),
                  int(rng.integers(1, 4)))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _background_v2(rng, h, w):
    """One of four background families (v1 had only gradient+noise)."""
    kind = rng.integers(0, 4)
    if kind == 0:      # v1-style gradient + value noise
        img = np.zeros((h, w, 3), np.float32)
        for c in range(3):
            a, b = rng.random(2)
            gx = np.linspace(a, b, w, dtype=np.float32)[None, :]
            c0, c1 = rng.random(2)
            gy = np.linspace(c0, c1, h, dtype=np.float32)[:, None]
            img[..., c] = 0.5 * gx + 0.5 * gy
        tex = _value_noise(rng, h, w)
        return 0.6 * img + 0.4 * tex[..., None] * rng.random(3)[None, None]
    if kind == 1:      # warped stripes (wood/marble-like)
        period = float(rng.uniform(8, 60))
        phase = _value_noise(rng, h, w, octaves=3) * rng.uniform(2, 12)
        yy = np.arange(h, dtype=np.float32)[:, None] / period
        stripes = 0.5 + 0.5 * np.sin(2 * np.pi * yy + phase)
        c0, c1 = rng.random(3), rng.random(3)
        return (stripes[..., None] * c0 + (1 - stripes[..., None]) * c1
                ).astype(np.float32)
    if kind == 2:      # thresholded-noise blobs over flat color
        base = rng.random(3).astype(np.float32)
        img = np.broadcast_to(base, (h, w, 3)).copy()
        for _ in range(int(rng.integers(1, 4))):
            n = _value_noise(rng, h, w, octaves=int(rng.integers(3, 6)))
            m = (n > rng.uniform(0.45, 0.6)).astype(np.float32)
            img = img * (1 - m[..., None]) + \
                m[..., None] * rng.random(3).astype(np.float32)
        return img
    # kind == 3: perspective brick/checker grid (structured geometry)
    cell = int(rng.integers(20, 80))
    gy, gx = np.mgrid[0:h, 0:w]
    a, b = rng.uniform(-3e-4, 3e-4, 2)
    u = gx * (1 + a * gy)
    v = gy * (1 + b * gx)
    cells = ((u // cell).astype(int) + (v // cell).astype(int)) % 2
    c0, c1 = rng.random(3), rng.random(3)
    return (cells[..., None] * c0 + (1 - cells[..., None]) * c1
            ).astype(np.float32)


def make_image_v2(rng, h, w):
    """Style v2: 4 background families, text glyphs, concentric rings,
    star polygons, translucent shapes, per-image gamma/contrast/blur."""
    img = np.clip(_background_v2(rng, h, w), 0, 1)

    n_shapes = rng.integers(10, 45)
    for _ in range(n_shapes):
        color = rng.random(3).astype(float)
        alpha = 1.0 if rng.random() < 0.7 else float(rng.uniform(0.3, 0.9))
        kind = rng.integers(0, 7)
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        s = int(rng.integers(6, max(8, min(h, w) // 3)))
        layer = img.copy() if alpha < 1.0 else img
        if kind == 0:    # polygon
            k = rng.integers(3, 8)
            ang = np.sort(rng.random(k) * 2 * np.pi)
            r = s * (0.4 + 0.6 * rng.random(k))
            pts = np.stack([x + r * np.cos(ang), y + r * np.sin(ang)],
                           -1).astype(np.int32)
            draw.fill_poly(layer, [pts], color)
        elif kind == 1:  # rotated rectangle
            box = draw.box_points((x, y), (s, s * rng.random() + 3),
                                  float(rng.random() * 180))
            draw.fill_poly(layer, [box.astype(np.int32)], color)
        elif kind == 2:  # ellipse
            draw.fill_ellipse(layer, (x, y),
                              (s, max(3, int(s * rng.random()))),
                              float(rng.random() * 180), color)
        elif kind == 3:  # checker patch
            cells = int(rng.integers(2, 6))
            cs = max(3, s // cells)
            for i in range(cells):
                for j in range(cells):
                    if (i + j) % 2 == 0:
                        x0, y0 = x + j * cs, y + i * cs
                        draw.rectangle(layer, (x0, y0), (x0 + cs, y0 + cs),
                                       color)
        elif kind == 4:  # text glyphs (corner-rich at many scales)
            # drawn on a uint8 mask and composited, as the JAX app does
            chars = "".join(chr(int(c)) for c in rng.integers(33, 127, 6))
            mask = np.zeros((h, w), np.uint8)
            put_text(mask, chars, (x, y), int(rng.integers(0, 8)),
                     float(rng.uniform(0.5, 3.0)), 255,
                     int(rng.integers(1, 4)))
            m = (mask.astype(np.float32) / 255.0)[..., None]
            layer[:] = layer * (1 - m) + m * color
        elif kind == 5:  # concentric rings
            for rr in range(s, 2, -max(3, s // int(rng.integers(2, 6)))):
                draw.circle(layer, (x, y), rr, rng.random(3).astype(float))
        else:            # star polygon
            k = int(rng.integers(4, 9))
            ang = np.linspace(0, 2 * np.pi, 2 * k, endpoint=False) + \
                rng.random() * np.pi
            r = np.where(np.arange(2 * k) % 2 == 0, s, s * 0.4)
            pts = np.stack([x + r * np.cos(ang), y + r * np.sin(ang)],
                           -1).astype(np.int32)
            draw.fill_poly(layer, [pts], color)
        if alpha < 1.0:
            img = (1 - alpha) * img + alpha * layer

    for _ in range(int(rng.integers(3, 16))):
        p0 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        draw.line(img, p0, p1, rng.random(3).astype(float),
                  int(rng.integers(1, 4)))

    # per-image photometric character: gamma, contrast, optional mild blur
    img = np.clip(img, 0, 1) ** float(rng.uniform(0.6, 1.6))
    img = np.clip(0.5 + (img - 0.5) * rng.uniform(0.7, 1.3), 0, 1)
    if rng.random() < 0.25:
        k = int(rng.integers(1, 3)) * 2 + 1
        img = draw.gaussian_blur(img, k)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def pool_digests(out: str) -> Dict[str, str]:
    """The sha256 of the decoded pixels of every PNG of a pool written to
    `out` and `<out>_holdout`: the (H, W, 3) uint8 BGR array (`read_png`,
    as `cv2.imread` gives it) in C order, keyed `train/<name>` and
    `holdout/<name>`."""
    dirs = {"train": Path(out), "holdout": Path(str(out).rstrip("/")
                                                + "_holdout")}
    return {f"{part}/{f.name}": hashlib.sha256(
                np.ascontiguousarray(read_png(f)).tobytes()).hexdigest()
            for part, d in dirs.items() for f in sorted(d.glob("*.png"))}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--res", type=str, default="800x608")
    ap.add_argument("--holdout", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--style", type=str, default="v2", choices=["v1", "v2"],
                    help="v1: the first generator (kept reproducible for "
                         "the recorded convergence tables); v2: more "
                         "background/shape/photometric variety")
    ap.add_argument("--prefix", type=str, default="img",
                    help="filename prefix; a distinct prefix extends an "
                         "existing pool dir without collisions")
    args = ap.parse_args(argv)
    w, h = map(int, args.res.split("x"))
    rng = np.random.default_rng(args.seed)
    gen = make_image if args.style == "v1" else make_image_v2
    os.makedirs(args.out, exist_ok=True)
    hold_dir = args.out.rstrip("/") + "_holdout"
    if args.holdout:
        os.makedirs(hold_dir, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(args.n + args.holdout):
        im = gen(rng, h, w)
        d = args.out if i < args.n else hold_dir
        write_png(os.path.join(d, f"{args.prefix}_{i:05d}.png"), im)
    wall = time.perf_counter() - t0
    print(f"wrote {args.n} train + {args.holdout} holdout images "
          f"({w}x{h}, style {args.style}) to {args.out}[,_holdout]")
    return {"train": args.n, "holdout": args.holdout, "width": w,
            "height": h, "style": args.style, "out": args.out,
            "holdout_dir": hold_dir if args.holdout else None,
            "seconds": wall}


if __name__ == "__main__":
    main()
