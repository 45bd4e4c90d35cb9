"""Smoke run of the port's extraction and matching (counterpart of the
JAX package's `apps/minimal_example.py`): single, repeated and batched
extraction and both matchers on seeded random inputs, with a random
extractor; prints shapes and a rate.

    python -m accelerated_features_tpu_torch.apps.minimal_example \\
        [--res 640x480] [--device cpu]

The device defaults to the GPU and the run raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np

from ..api import XFeat


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=str, default="640x480")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)
    w, h = map(int, args.res.split("x"))

    xfeat = XFeat(weights=None, top_k=4096, detection_threshold=0.012,
                  device=args.device)
    rng = np.random.default_rng(0)
    out: Dict[str, object] = {}

    x = rng.random((h, w, 3), np.float32)
    res = xfeat.detectAndCompute(x, top_k=4096)[0]
    out["detectAndCompute"] = {k: tuple(v.shape) for k, v in res.items()}
    print("detectAndCompute:", out["detectAndCompute"])

    # stress test
    x = rng.random((1, h, w, 3), np.float32)
    t0 = time.time()
    for _ in range(20):
        xfeat.detectAndCompute(x, top_k=4096)
    out["calls_per_s"] = 20 / (time.time() - t0)
    print(f"stress: {out['calls_per_s']:.1f} calls/s (b=1 {w}x{h}) on "
          f"{xfeat.device}")

    # batched mode
    x = rng.random((4, h, w, 3), np.float32)
    out["batched"] = len(xfeat.detectAndCompute(x, top_k=4096))
    print(f"batched: {out['batched']} results")

    # semi-dense matching
    x1 = rng.random((h, w, 3), np.float32)
    x2 = rng.random((h, w, 3), np.float32)
    mk0, mk1 = xfeat.match_xfeat_star(x1, x2, top_k=5000)
    out["match_xfeat_star"] = (mk0.shape, mk1.shape)
    print("match_xfeat_star:", mk0.shape, mk1.shape)

    # sparse matching
    mk0, mk1 = xfeat.match_xfeat(x1, x2, top_k=4096)
    out["match_xfeat"] = (mk0.shape, mk1.shape)
    print("match_xfeat:", mk0.shape, mk1.shape)
    return out


if __name__ == "__main__":
    main()
