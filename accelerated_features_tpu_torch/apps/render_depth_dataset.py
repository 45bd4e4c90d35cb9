"""Render a procedural depth dataset in the MegaDepth on-disk layout
(counterpart of the JAX package's `apps/render_depth_dataset.py`), without
cv2 or h5py:

  <out>/MegaDepth_v1/rendered/scene_NNNN/imgs/view_V.png
  <out>/MegaDepth_v1/rendered/scene_NNNN/depths/view_V.h5   ('/depth')
  <out>/train_data/megadepth_indices/scene_info_0.1_0.7/scene_NNNN.npz
      (image_paths, depth_paths, intrinsics, poses, pair_infos)

what `train/megadepth.py` and `train/run.py --megadepth_root_path <out>`
read, plus, for `--holdout_scenes` more scenes (never indexed for
training), a relative-pose eval manifest in the megadepth_1500.json
schema (pair_names, K0, K1, T_0to1, overlap) at
<out>/rendered_pose_pairs.json, which `eval/megadepth1500` takes as
`--data_root <out> --json <out>/rendered_pose_pairs.json`.

From the same `--textures` and `--seed` it makes the same draws as the
JAX app and writes the same tree: the renderer is `train/render.py`, the
images are PNGs by `utils/imageio.write_png` (cv2.imread reads the JAX
app's pixels), the depths gzip-chunked HDF5 by `utils/hdf5.write_dataset`
(h5py's chunk shape and level; h5py reads the same arrays).

    python -m accelerated_features_tpu_torch.apps.render_depth_dataset \\
        --out /tmp/rendered_md --textures DIR --scenes 50 --views 4 \\
        --holdout_scenes 15 [--res 800x608] [--seed 0]

DIR's own `*.png` and `*.jpg` are the texture pool (not searched
recursively, as the JAX app takes them).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..train.render import pair_overlap, render_scene_views
from ..utils.hdf5 import write_dataset
from ..utils.imageio import load_textures, write_png

INDEX_DIR = os.path.join("train_data", "megadepth_indices",
                         "scene_info_0.1_0.7")


def write_scene(scene_dir: str, views: Dict[str, list]
                ) -> Tuple[List[str], List[str]]:
    """Write imgs/ and depths/ of one rendered scene; returns the image and
    depth paths relative to MegaDepth_v1."""
    os.makedirs(os.path.join(scene_dir, "imgs"), exist_ok=True)
    os.makedirs(os.path.join(scene_dir, "depths"), exist_ok=True)
    rel = os.path.relpath(scene_dir, os.path.join(scene_dir, "..", ".."))
    img_paths, depth_paths = [], []
    for vi, (img, depth) in enumerate(zip(views["images"], views["depths"])):
        write_png(os.path.join(scene_dir, "imgs", f"view_{vi}.png"), img)
        write_dataset(os.path.join(scene_dir, "depths", f"view_{vi}.h5"),
                      depth, compression="gzip")
        img_paths.append(os.path.join(rel, "imgs", f"view_{vi}.png"))
        depth_paths.append(os.path.join(rel, "depths", f"view_{vi}.h5"))
    return img_paths, depth_paths


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--textures", type=str, required=True)
    ap.add_argument("--scenes", type=int, default=50)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--holdout_scenes", type=int, default=15,
                    help="extra scenes for the relative-pose eval JSON "
                         "(never indexed for training)")
    ap.add_argument("--res", type=str, default="800x608")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quads", type=int, default=12)
    ap.add_argument("--textures_per_scene", type=int, default=16)
    ap.add_argument("--min_overlap", type=float, default=0.3)
    ap.add_argument("--scene_offset", type=int, default=0,
                    help="offset added to scene numbering so several "
                         "renderer processes can shard one dataset")
    ap.add_argument("--baseline", type=str, default="0.08,0.35",
                    help="min,max camera baseline as a fraction of the "
                         "scene distance (wider = harder pairs)")
    args = ap.parse_args(argv)
    b_lo, b_hi = map(float, args.baseline.split(","))
    w, h = map(int, args.res.split("x"))
    rng = np.random.default_rng(args.seed)

    md_root = os.path.join(args.out, "MegaDepth_v1")
    idx_dir = os.path.join(args.out, INDEX_DIR)
    os.makedirs(idx_dir, exist_ok=True)

    n_total = args.scenes + args.holdout_scenes
    eval_pairs = []
    n_train_pairs = 0
    for si in range(n_total):
        train_scene = si < args.scenes
        texs = load_textures(args.textures, args.textures_per_scene, rng,
                             recursive=False)
        views = render_scene_views(rng, texs, args.views, w, h,
                                   n_quads=args.quads,
                                   baseline_frac=(b_lo, b_hi))
        sn = si + args.scene_offset
        name = f"scene_{sn:04d}" if train_scene else f"holdout_{sn:04d}"
        img_paths, depth_paths = write_scene(
            os.path.join(md_root, "rendered", name), views)

        # all view pairs with overlap inside the training filter window
        pair_infos = []
        for i in range(args.views):
            for j in range(i + 1, args.views):
                T_i2j = views["poses"][j] @ np.linalg.inv(views["poses"][i])
                ov = pair_overlap(views["depths"][i], views["depths"][j],
                                  views["Ks"][i], views["Ks"][j], T_i2j)
                if not (args.min_overlap < ov < 1.0):
                    continue
                if train_scene:
                    pair_infos.append(((i, j), float(ov), 0))
                else:
                    eval_pairs.append({
                        "pair_names": [
                            os.path.join("MegaDepth_v1", img_paths[i]),
                            os.path.join("MegaDepth_v1", img_paths[j])],
                        "K0": views["Ks"][i].tolist(),
                        "K1": views["Ks"][j].tolist(),
                        "T_0to1": T_i2j.tolist(),
                        "overlap": float(ov),
                    })

        if train_scene:
            n_train_pairs += len(pair_infos)
            np.savez(
                os.path.join(idx_dir, f"{name}.npz"),
                image_paths=np.array(img_paths, dtype=object),
                depth_paths=np.array(depth_paths, dtype=object),
                intrinsics=np.array([k for k in views["Ks"]]),
                poses=np.array([p for p in views["poses"]]),
                pair_infos=np.array(
                    [(np.array(ij), ov, nc)
                     for (ij, ov, nc) in pair_infos], dtype=object),
            )
        if (si + 1) % 10 == 0:
            print(f"[{si + 1}/{n_total}] scenes rendered "
                  f"({n_train_pairs} train pairs so far)", flush=True)

    if eval_pairs:
        with open(os.path.join(args.out, "rendered_pose_pairs.json"),
                  "w") as f:
            json.dump(eval_pairs, f)
    print(f"done: {args.scenes} train scenes ({n_train_pairs} pairs), "
          f"{args.holdout_scenes} holdout scenes "
          f"({len(eval_pairs)} eval pairs) at {args.out}")
    return {"train_pairs": n_train_pairs, "eval_pairs": len(eval_pairs)}


if __name__ == "__main__":
    main()
