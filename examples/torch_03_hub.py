"""Hub-style model loading with the PyTorch port (port version of
`03_hub.py`): the entries of `accelerated_features_tpu_torch/hub.py`,
called as a module (the repository's root `hubconf.py`, which
`torch.hub.load` reads, serves the JAX package).

    python examples/torch_03_hub.py [--device cpu]

Runs on the GPU unless given `--device cpu`.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from accelerated_features_tpu_torch import hub

    xfeat = hub.XFeat(weights=None, top_k=1024, device=args.device)
    x = np.random.default_rng(0).uniform(0, 1, (480, 640, 3)).astype(
        np.float32)
    out = xfeat.detectAndCompute(x, detection_threshold=0.012)[0]
    print(len(out["keypoints"]), "keypoints via hub entry on",
          xfeat.device)
    matcher = hub.LighterGlue(weights=None, device=args.device)
    print("LighterGlue via hub entry:", matcher.conf["n_layers"], "layers")


if __name__ == "__main__":
    main()
