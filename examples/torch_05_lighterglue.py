"""LighterGlue attention matching with the PyTorch port (port version of
`05_lighterglue.py`): the first pair of the committed rendered holdout,
read without cv2, through the trained extractor and the trained matcher
`artifacts/lighterglue_ft_ckpt7791.npz` at its confidence gate 0.01.

    python examples/torch_05_lighterglue.py [--device cpu]

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
    xfeat = XFeat(top_k=2048, device=args.device)
    xfeat.set_lighterglue(os.path.join(ROOT, "artifacts",
                                       "lighterglue_ft_ckpt7791.npz"))
    d0 = xfeat.detectAndCompute(im0)[0]
    d1 = xfeat.detectAndCompute(im1)[0]
    d0["image_size"] = (im0.shape[1], im0.shape[0])
    d1["image_size"] = (im1.shape[1], im1.shape[0])
    mk0, mk1, idx = xfeat.match_lighterglue(d0, d1, min_conf=0.01)
    print(f"LighterGlue matches: {len(idx)} ({len(d0['keypoints'])} and "
          f"{len(d1['keypoints'])} keypoints) on {xfeat.device}")


if __name__ == "__main__":
    main()
