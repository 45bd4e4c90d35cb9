"""Matching, a robust homography and the warped image with the PyTorch
port (port version of `02_homography.py`): the first pair of the
committed rendered holdout, read without cv2, through the trained
extractor, posekit's LO-RANSAC homography, `warp_perspective` and
`write_png` (cv2's `warpPerspective` and `imwrite` without cv2).

    python examples/torch_02_homography.py [--out warped.png] [--device cpu]

Runs on the GPU unless given `--device cpu`.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
HOLDOUT = os.path.join(ROOT, "artifacts", "rendered_pose_holdout")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="warped.png",
                    help="where the warped first image goes")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from accelerated_features_tpu_torch import XFeat
    from accelerated_features_tpu_torch.geometry import estimate_homography
    from accelerated_features_tpu_torch.utils.imageio import (
        read_png, warp_perspective, write_png)

    with open(os.path.join(HOLDOUT, "rendered_pose_pairs.json")) as f:
        names = json.load(f)[0]["pair_names"]
    im0, im1 = (read_png(os.path.join(HOLDOUT, n)) for n in names)
    xfeat = XFeat(top_k=4096, device=args.device)
    mk0, mk1 = xfeat.match_xfeat(im0, im1)
    print(f"{len(mk0)} matches on {xfeat.device}")
    res = estimate_homography(mk0.astype(np.float64),
                              mk1.astype(np.float64), thresh=4.0)
    if res is None:
        print("homography failed")
        return
    H, inl = res
    print(f"homography inliers: {inl.sum()}\nH=\n{np.round(H, 4)}")
    warp = warp_perspective(im0, H, (im1.shape[1], im1.shape[0]))
    write_png(args.out, warp)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
