"""Render a ScanNet-1500-layout fixture from procedural scenes
(counterpart of the JAX package's `apps/render_scannet_fixture.py`),
without cv2, so that `eval/scannet1500.py` runs end to end offline:

  <out>/scene{SSSS}_{VV}/color/{i}.jpg
  <out>/scene{SSSS}_{VV}/pose/{i}.txt            (camera-to-world 4x4)
  <out>/scene{SSSS}_{VV}/intrinsic/intrinsic_color.txt
  <out>/test.npz                                 (array 'name': rows of
                                                  (scene, sub, im0, im1))

plus, beside the ScanNet layout, each view's exact rendered depth as
`depth/{i}.npy`. From the same `--textures` and `--seed` it makes the JAX
app's draws and writes its tree; the frames are JPEGs by
`utils/imageio.write_jpeg`, the bytes `cv2.imwrite` writes.

    python -m accelerated_features_tpu_torch.apps.render_scannet_fixture \\
        --out /tmp/scannet_fixture --textures DIR [--scenes 2] [--views 3] \\
        [--res 320x240] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Tuple

import numpy as np

from ..train.render import render_scene_views
from ..utils.imageio import load_textures, write_jpeg


def render_fixture(out: str, textures_dir: str, scenes: int = 2,
                   views: int = 3, w: int = 320, h: int = 240,
                   seed: int = 0, quads: int = 12
                   ) -> List[Tuple[int, int, int, int]]:
    """Render and write the fixture; returns its pair rows."""
    rng = np.random.default_rng(seed)
    names = []
    for si in range(scenes):
        sdir = os.path.join(out, f"scene{si:04d}_00")
        for sub in ("color", "pose", "intrinsic", "depth"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        texs = load_textures(textures_dir, 12, rng, recursive=False)
        vs = render_scene_views(rng, texs, views, w, h, n_quads=quads)
        np.savetxt(os.path.join(sdir, "intrinsic", "intrinsic_color.txt"),
                   np.block([[vs["Ks"][0], np.zeros((3, 1))],
                             [np.zeros((1, 3)), np.ones((1, 1))]]))
        for vi in range(views):
            write_jpeg(os.path.join(sdir, "color", f"{vi}.jpg"),
                       vs["images"][vi])
            # ScanNet poses are camera-to-world (the eval inverts them)
            np.savetxt(os.path.join(sdir, "pose", f"{vi}.txt"),
                       np.linalg.inv(vs["poses"][vi]))
            np.save(os.path.join(sdir, "depth", f"{vi}.npy"),
                    vs["depths"][vi])
        for i in range(views):
            for j in range(i + 1, views):
                names.append((si, 0, i, j))
    np.savez(os.path.join(out, "test.npz"), name=np.asarray(names, np.int32))
    return names


def main(argv=None) -> List[Tuple[int, int, int, int]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--textures", type=str, required=True)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--res", type=str, default="320x240")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    w, h = map(int, args.res.split("x"))
    names = render_fixture(args.out, args.textures, args.scenes, args.views,
                           w, h, args.seed)
    print(f"done: {args.scenes} scenes, {len(names)} pairs at {args.out}")
    return names


if __name__ == "__main__":
    main()
