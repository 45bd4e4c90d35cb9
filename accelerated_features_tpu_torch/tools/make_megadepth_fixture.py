"""Write a small MegaDepth-layout dataset of rendered scenes: the test
fixture `tests/fixtures/megadepth_mini` of the port's MegaDepth reader.

    python -m accelerated_features_tpu_torch.tools.make_megadepth_fixture \\
        --out tests/fixtures/megadepth_mini \\
        --textures artifacts/rendered_pose_holdout/MegaDepth_v1 \\
        --full_size_out tests/fixtures/megadepth_depth_608x800

The layout is MegaDepth's, as `train/megadepth.py` reads it:

    <out>/MegaDepth_v1/rendered/<scene>/imgs/view_<v>.{jpg,png}
    <out>/MegaDepth_v1/rendered/<scene>/depths/view_<v>.h5   ('/depth')
    <out>/MegaDepth_v1/rendered/<scene>/depths/view_<v>.npy  (its twin)
    <out>/train_data/megadepth_indices/scene_info_0.1_0.7/<scene>.npz

Scenes are rendered by `train/render.render_scene_views` and their pairs
indexed by `train/render.pair_overlap`, as `apps/render_depth_dataset.py`
does. Scene 0 stores JPEG images (`cv2.imwrite`, quality 95, as MegaDepth
stores its photographs) and gzip-chunked depth maps (h5py's
`compression="gzip"`, as the renderer writes them); scene 1 stores color
PNGs (as the renderer writes them) and contiguous depth maps (h5py's
default). Every depth map has an `.npy` twin, the reference a reader
without h5py is held to. `--full_size_out` also writes one depth map at
the training size, 800x608, gzip-chunked as the renderer writes it
(`depth.h5`, and its twin `depth.npy`): the map whose host read time
the reader is judged by.

Writing needs cv2 and h5py; nothing on the training path imports this
module.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train.render import pair_overlap, render_scene_views
from ..utils.imageio import load_textures

INDEX_DIR = os.path.join("train_data", "megadepth_indices",
                         "scene_info_0.1_0.7")


def write_fixture(out: str, textures: str, scenes: int = 2, views: int = 3,
                  res=(320, 240), seed: int = 5, n_textures: int = 12,
                  min_overlap: float = 0.3) -> int:
    """Render and write the dataset; returns the number of indexed
    pairs."""
    import cv2
    import h5py

    w, h = res
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out, INDEX_DIR), exist_ok=True)
    n_pairs = 0
    for si in range(scenes):
        jpeg = si % 2 == 0
        texs = load_textures(textures, n_textures, rng)
        v = render_scene_views(rng, texs, views, w, h)
        name = f"scene_{si:04d}"
        rel = os.path.join("rendered", name)
        scene_dir = os.path.join(out, "MegaDepth_v1", rel)
        os.makedirs(os.path.join(scene_dir, "imgs"), exist_ok=True)
        os.makedirs(os.path.join(scene_dir, "depths"), exist_ok=True)
        img_paths, depth_paths = [], []
        for vi, (img, depth) in enumerate(zip(v["images"], v["depths"])):
            ext = "jpg" if jpeg else "png"
            ip = os.path.join(rel, "imgs", f"view_{vi}.{ext}")
            dp = os.path.join(rel, "depths", f"view_{vi}.h5")
            params = [cv2.IMWRITE_JPEG_QUALITY, 95] if jpeg else []
            if not cv2.imwrite(os.path.join(out, "MegaDepth_v1", ip), img,
                               params):
                raise OSError(f"cv2 could not write {ip}")
            with h5py.File(os.path.join(out, "MegaDepth_v1", dp), "w") as f:
                if jpeg:
                    f.create_dataset("depth", data=depth,
                                     compression="gzip")
                else:
                    f.create_dataset("depth", data=depth)
            np.save(os.path.join(out, "MegaDepth_v1",
                                 dp[:-len(".h5")] + ".npy"), depth)
            img_paths.append(ip)
            depth_paths.append(dp)
        pair_infos = []
        for i in range(views):
            for j in range(i + 1, views):
                T = v["poses"][j] @ np.linalg.inv(v["poses"][i])
                ov = pair_overlap(v["depths"][i], v["depths"][j],
                                  v["Ks"][i], v["Ks"][j], T)
                if min_overlap < ov < 1.0:
                    pair_infos.append((np.array([i, j]), float(ov), 0))
        n_pairs += len(pair_infos)
        np.savez(os.path.join(out, INDEX_DIR, f"{name}.npz"),
                 image_paths=np.array(img_paths, dtype=object),
                 depth_paths=np.array(depth_paths, dtype=object),
                 intrinsics=np.array(v["Ks"]), poses=np.array(v["poses"]),
                 pair_infos=np.array(pair_infos, dtype=object))
    return n_pairs


def write_full_size_map(out: str, textures: str, res=(800, 608),
                        seed: int = 6, n_textures: int = 12) -> None:
    """One view of a rendered scene at `res`: its depth as `depth.h5`
    (gzip-chunked) and `depth.npy`."""
    import h5py

    w, h = res
    rng = np.random.default_rng(seed)
    texs = load_textures(textures, n_textures, rng)
    depth = render_scene_views(rng, texs, 1, w, h)["depths"][0]
    os.makedirs(out, exist_ok=True)
    with h5py.File(os.path.join(out, "depth.h5"), "w") as f:
        f.create_dataset("depth", data=depth, compression="gzip")
    np.save(os.path.join(out, "depth.npy"), depth)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--textures", required=True,
                    help="a directory searched recursively for PNGs")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--res", default="320x240", help="WxH of the views")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--full_size_out", default=None,
                    help="also write one 800x608 depth map here")
    args = ap.parse_args(argv)
    res = tuple(int(x) for x in args.res.split("x"))
    n = write_fixture(args.out, args.textures, args.scenes, args.views, res,
                      args.seed)
    print(f"{args.scenes} scenes, {n} pairs at {args.out}")
    if args.full_size_out:
        write_full_size_map(args.full_size_out, args.textures,
                            seed=args.seed + 1)
        print(f"one 800x608 depth map at {args.full_size_out}")


if __name__ == "__main__":
    main()
