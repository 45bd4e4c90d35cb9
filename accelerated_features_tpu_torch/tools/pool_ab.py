"""A/B of the synthetic pool's host wall: style v1 images at 800x608 made
by two checkouts of the port, in turn A, B, B, A.

    python -m accelerated_features_tpu_torch.tools.pool_ab \\
        --a PARENT_CHECKOUT --b CHECKOUT [--n 12] [--res 800x608]

Each turn is a process of its own that imports `apps/make_synthetic_pool`
from its checkout and times `make_image` on `--n` images from seed 0
after one image of warm-up; the host is all it uses. One JSON line a
turn (checkout, seconds an image, the pixels' sha256 of the last image),
then one with each side's mean and B's over A's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Dict, List, Optional

TURN = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
from accelerated_features_tpu_torch.apps.make_synthetic_pool import make_image
n, w, h = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
rng = np.random.default_rng(0)
make_image(rng, h, w)
t0 = time.perf_counter()
for _ in range(n):
    im = make_image(rng, h, w)
s = (time.perf_counter() - t0) / n
print(json.dumps({"s_per_image": s, "sha256": hashlib.sha256(
    np.ascontiguousarray(im).tobytes()).hexdigest()}))
"""


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", required=True, help="checkout A (the parent)")
    ap.add_argument("--b", required=True, help="checkout B (the change)")
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--res", default="800x608")
    args = ap.parse_args(argv)
    w, h = args.res.split("x")
    walls: Dict[str, List[float]] = {"a": [], "b": []}
    for side in ("a", "b", "b", "a"):
        root = getattr(args, side)
        out = subprocess.run([sys.executable, "-c", TURN, root, str(args.n),
                              w, h], capture_output=True, text=True,
                             check=True, timeout=600).stdout
        turn = json.loads(out.strip().splitlines()[-1])
        walls[side].append(turn["s_per_image"])
        print(json.dumps({"side": side, "checkout": root, **turn}),
              flush=True)
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    summary = {"a_s_per_image": mean["a"], "b_s_per_image": mean["b"],
               "b_over_a": mean["b"] / mean["a"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
