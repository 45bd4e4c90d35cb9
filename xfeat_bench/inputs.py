"""The benchmark's inputs, made from the repository and `--seed` alone.

- `decode_png`: a frozen copy of the port's PNG decoder (zlib and numpy;
  8-bit, non-interlaced gray, RGB and RGBA, all five scanline filters),
  returning RGB.
- `Views`: the 60 rendered 800x608 holdout views and the 150 posed pairs
  of `rendered_pose_pairs.json`, read once.
- `homographies` and `warp`: one mild random homography per view, drawn
  from the seed, applied by bilinear sampling (zeros outside the source)
  and rounded back to uint8, in the manner of the synthetic-homography
  evaluations.
- `host_tensor`: a request's input in the host memory it is sent from.

Every seed gets the same amount of work: the same number of requests of
the same shapes; the seed chooses the views or pairs, their order, and
the warps.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter_bytewise(kind: int, line: np.ndarray, prior: np.ndarray,
                       bpp: int) -> np.ndarray:
    """Filters 3 (average) and 4 (Paeth), byte by byte."""
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
    """The bytes of an 8-bit, non-interlaced gray, RGB or RGBA PNG ->
    (H, W, 3) uint8 RGB; anything else raises ValueError."""
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
        raise ValueError(f"unsupported PNG (bit depth {depth}, color type "
                         f"{color}, interlace {interlace})")
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
        elif kind == 1:
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
    return np.ascontiguousarray(img[..., :3])


class Views:
    """The holdout views (decoded, in the order of their sorted paths)
    and the posed pairs as index pairs into them."""

    def __init__(self, root: Path, pairs_file: str,
                 crop_hw: Tuple[int, int] = None):
        root = Path(root)
        paths = sorted(root.rglob("*.png"))
        if not paths:
            raise FileNotFoundError(f"no PNG views under {root}")
        names = [p.relative_to(root).as_posix() for p in paths]
        self.images = np.stack([decode_png(p.read_bytes()) for p in paths])
        if crop_hw is not None:          # tests: a small centre crop
            H, W = self.images.shape[1:3]
            h, w = crop_hw
            y0, x0 = (H - h) // 2, (W - w) // 2
            self.images = np.ascontiguousarray(
                self.images[:, y0:y0 + h, x0:x0 + w])
        where = {n: i for i, n in enumerate(names)}
        posed = json.loads((root / pairs_file).read_text())
        self.pairs = [(where[p["pair_names"][0]], where[p["pair_names"][1]])
                      for p in posed]

    @property
    def hw(self) -> Tuple[int, int]:
        return tuple(self.images.shape[1:3])


def homographies(rng: np.random.Generator, n: int, hw: Tuple[int, int],
                 spec: Dict[str, float]) -> np.ndarray:
    """n homographies (n,3,3) about the image centre: rotation, isotropic
    scale, shear, translation and a small projective part, each drawn
    uniformly within `spec`'s bounds."""
    h, w = hw
    out = np.empty((n, 3, 3))
    for i in range(n):
        ang = np.deg2rad(rng.uniform(-spec["rotation_deg"],
                                     spec["rotation_deg"]))
        sc = np.exp(rng.uniform(-np.log(spec["scale"]),
                                np.log(spec["scale"])))
        shear = rng.uniform(-spec["shear"], spec["shear"])
        tx, ty = rng.uniform(-spec["translation"], spec["translation"],
                             2) * [w, h]
        px, py = rng.uniform(-spec["perspective"], spec["perspective"],
                             2) / np.array([w, h])
        c, s = np.cos(ang), np.sin(ang)
        a = np.array([[sc * c, sc * (shear - s), tx],
                      [sc * s, sc * c, ty],
                      [px, py, 1.0]])
        t0 = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]])
        t1 = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1]])
        out[i] = t1 @ a @ t0
    return out


def warp(images: torch.Tensor, hom: np.ndarray) -> torch.Tensor:
    """(B,H,W,3) uint8 on any device, (B,3,3) homographies mapping source
    to destination pixels -> (B,H,W,3) uint8: each destination pixel
    samples the source bilinearly at H^-1 (pixel centres at integers,
    zeros outside), rounded half up."""
    b, h, w, _ = images.shape
    dev = images.device
    inv = torch.tensor(np.linalg.inv(hom), dtype=torch.float64, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = torch.einsum("bij,nj->bni", inv, pts)
    src = src[..., :2] / src[..., 2:]
    grid = torch.stack([2 * src[..., 0] / (w - 1) - 1,
                        2 * src[..., 1] / (h - 1) - 1], -1)
    grid = grid.reshape(b, h, w, 2).float()
    out = F.grid_sample(images.permute(0, 3, 1, 2).float(), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    out = torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()


def draw(rng: np.random.Generator, pool: int, n: int) -> np.ndarray:
    """n indices into range(pool): whole permutations of the pool, one
    after another, so each seed uses every member equally often."""
    reps = -(-n // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:n]


def warped_views(views: Views, index: Sequence[int],
                 rng: np.random.Generator, spec: Dict[str, float],
                 device, chunk: int = 32) -> np.ndarray:
    """The views `index`, each under its own homography, as one (N,H,W,3)
    uint8 array in host memory. Warped on `device`, `chunk` at a time."""
    hom = homographies(rng, len(index), views.hw, spec)
    out = np.empty((len(index),) + views.images.shape[1:], np.uint8)
    for c0 in range(0, len(index), chunk):
        sel = np.asarray(index[c0:c0 + chunk])
        src = torch.from_numpy(views.images[sel]).to(device)
        out[c0:c0 + len(sel)] = warp(src, hom[c0:c0 + len(sel)]).cpu().numpy()
    return out


def host_tensor(a: np.ndarray, pinned: bool) -> torch.Tensor:
    """A host copy of `a`: page-locked when `pinned` (with a card), else
    numpy's own memory."""
    if not pinned:
        return torch.from_numpy(np.ascontiguousarray(a))
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                    pin_memory=True)
    t.numpy()[...] = a
    return t


def pair_blocks(n_views: int) -> List[Tuple[int, int]]:
    """Every pair (i, j), i < j, of a block, in row order."""
    return [(i, j) for i in range(n_views) for j in range(i + 1, n_views)]
