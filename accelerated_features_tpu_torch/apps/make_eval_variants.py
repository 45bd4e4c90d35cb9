"""Resolution variants of a rendered pose-eval manifest (counterpart of the
JAX package's `apps/make_eval_variants.py`), without cv2.

The reference's published table evaluates at a longest side of 640
("Fast", 1300 keypoints) and 1024 ("Accurate", 4096 keypoints); the
megadepth_1500.json schema carries that as each pair's `size0_hw` /
`size1_hw` (the resize target) and `scale0` / `scale1` (keypoints at the
resized size -> the intrinsics' size), which `eval/megadepth1500` reads.
Image sizes come from the files (`utils/imageio.imread`, as cv2.imread).

    python -m accelerated_features_tpu_torch.apps.make_eval_variants \\
        --json PAIRS.json --data_root ROOT --max_dim 640 --out PAIRS_640.json
"""

from __future__ import annotations

import argparse
import json
import os

from ..utils.imageio import imread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", required=True)
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--max_dim", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    with open(args.json) as f:
        pairs = json.load(f)
    size_cache = {}
    for pair in pairs:
        for k, size_key, scale_key in [(0, "size0_hw", "scale0"),
                                       (1, "size1_hw", "scale1")]:
            name = pair["pair_names"][k]
            if name not in size_cache:
                size_cache[name] = imread(
                    os.path.join(args.data_root, name)).shape[:2]
            h, w = size_cache[name]
            s = args.max_dim / max(h, w)
            nh, nw = int(round(h * s)), int(round(w * s))
            pair[size_key] = [nh, nw]
            # keypoints at the resized size * scale -> intrinsics' size
            pair[scale_key] = [w / nw, h / nh]
    with open(args.out, "w") as f:
        json.dump(pairs, f)
    print(f"{len(pairs)} pairs -> {args.out} (max_dim {args.max_dim})")
    return len(pairs)


if __name__ == "__main__":
    main()
