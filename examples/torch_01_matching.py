"""Sparse and semi-dense matching on an image pair with the PyTorch port
(port version of `01_matching.py`): the first pair of the committed
rendered holdout, read without cv2, through the trained extractor.

    python examples/torch_01_matching.py [--device cpu]

Runs on the GPU unless given `--device cpu`.
"""
import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
HOLDOUT = os.path.join(ROOT, "artifacts", "rendered_pose_holdout")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from accelerated_features_tpu_torch import XFeat
    from accelerated_features_tpu_torch.utils.imageio import read_png

    with open(os.path.join(HOLDOUT, "rendered_pose_pairs.json")) as f:
        names = json.load(f)[0]["pair_names"]
    im0, im1 = (read_png(os.path.join(HOLDOUT, n)) for n in names)
    xfeat = XFeat(top_k=4096, device=args.device)

    out = xfeat.detectAndCompute(im0)[0]
    print(f"keypoints: {tuple(out['keypoints'].shape)}, descriptors: "
          f"{tuple(out['descriptors'].shape)}, score range "
          f"[{out['scores'].min():.3f}, {out['scores'].max():.3f}] on "
          f"{xfeat.device}")

    mk0, mk1 = xfeat.match_xfeat(im0, im1)
    print(f"sparse MNN matches: {len(mk0)}")

    sk0, sk1 = xfeat.match_xfeat_star(im0, im1)
    print(f"semi-dense refined matches: {len(sk0)}")


if __name__ == "__main__":
    main()
