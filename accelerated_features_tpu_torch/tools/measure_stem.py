"""A/B of the stem on the card: cuDNN's convolutions against kernel E
(counterpart of the JAX package's `apps/measure_stem.py`).

    python -m accelerated_features_tpu_torch.tools.measure_stem \\
        [--res 640x480 1024x768] [--batch 64] [--top_k 4096] [--iters 20] \\
        [--weights random|PATH] [--device cpu]

In bfloat16 at batch B, for each size:
  1. the stem alone (block1's four 3x3 convs and the avg-pool skip) on the
     normalized image: `models/backbone.stem_unfused` (cuDNN's convs, in
     full float32 arithmetic as the backbone runs them) against
     `ops/cuda/stem_fused.stem_fused` (kernel E);
  2. `ops/extraction.detect_and_compute` with `fused_stem=False` and
     `fused_stem=True`: the decision metric, since a faster stem alone need
     not make the extraction faster.
Images are U(0, 1) gray, seeded as the JAX probe seeds them. One JSON line
a size: the four ms a batch (`utils/profiling.scan_time`), the two frame
rates and the device with the card's power limit; then one line saying
whether the fused stem won at every size. The device defaults to the card
and the run raises without one; on the CPU (`--device cpu`) kernel E's
plain version runs in its place.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from ..api import resolve_device
from ..apps.eval_slam import device_label
from ..models.backbone import input_norm, stem_unfused
from ..ops.cuda.stem_fused import stem_fused
from ..ops.extraction import detect_and_compute
from ..ops.precision import full_fp32_convs
from ..utils.profiling import scan_time
from .measure_select import WEIGHTS, extractor_params


def run(args, device: torch.device) -> List[Dict]:
    label = device_label(device)
    params = extractor_params(args.weights, device)
    cdt = torch.bfloat16
    B, K = args.batch, args.top_k
    out = []
    for res in args.res:
        W, H = map(int, res.split("x"))
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 1)).astype(
            np.float32)).to(device)
        with torch.inference_mode():
            xg = input_norm(x).to(cdt)

        def cudnn(z):
            with full_fp32_convs():
                return stem_unfused(params, z)

        def timed(fn, *a):
            with torch.inference_mode():
                return scan_time(fn, *a, iters=args.iters) * 1e3

        r = {"res": res, "batch": B, "top_k": K, "dtype": "bfloat16",
             "stem_cudnn_ms": timed(cudnn, xg),
             "stem_fused_ms": timed(lambda z: stem_fused(params, z), xg)}
        for tag, fused in (("unfused", False), ("fused", True)):
            r[f"full_{tag}_ms"] = timed(
                lambda im, f=fused: detect_and_compute(
                    params, im, K, compute_dtype=cdt, fused_stem=f), x)
            r[f"full_fps_{tag}"] = B / r[f"full_{tag}_ms"] * 1e3
        r["device"] = label
        print(json.dumps(r), flush=True)
        out.append(r)
    win = all(r["full_fused_ms"] < r["full_unfused_ms"] for r in out)
    print(json.dumps({"fused_stem_wins_in_context_at_all_sizes": win,
                      "device": label}), flush=True)
    return out


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=str, nargs="+",
                    default=["640x480", "1024x768"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--weights", default=str(WEIGHTS),
                    help="the extractor ('random': the JAX probe's random "
                         "weights)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
