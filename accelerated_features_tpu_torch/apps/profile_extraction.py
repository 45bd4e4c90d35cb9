"""Per-stage extraction profiler (counterpart of the JAX package's
`apps/profile_extraction.py`): times each stage of the sparse extraction
on one device and prints a speed-of-light table.

Stages: input_norm | the four block1 convs | the stem (input norm, block1
and the avg-pool skip) as convolutions (cuDNN on the card) and, with
`--fused_stem`, through the fused stem kernel (E) | the backbone |
heatmap decode | detect (NMS, score, top-k: kernel A on the card) |
descriptor sampling (kernel B on the card) | the full
`detect_and_compute`.

    python -m accelerated_features_tpu_torch.apps.profile_extraction \\
        [--res 640x480] [--batch 64] [--dtype bfloat16] [--fused_stem] \\
        [--device cpu]

Each stage is timed by `utils/profiling.scan_time`: CUDA events on the
card (host clock on the CPU), every input moved by a few ulps each
iteration (uint8 frames by one), so no iteration reuses another's work.
The detect and sampling stages call the wrappers `ops/extraction` calls,
so they time the path the pipeline runs on that device. SoL is the least
time one H100 SXM (`utils/profiling.speed_of_light`) takes for the
stage's operations and bytes: the backbone and stem counted conv by conv
(each activation read and written once; the avg-pool skip's 1x1 conv
included), detect and sampling counted as the bytes and operations of
their function, as `chip_smoke.py` bounds kernels A and B. The header
names the device and, on the card, its power limit. Weights are random
(seed 0), as in the JAX profiler. The device defaults to the GPU and the
run raises without one.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import XFeat, resolve_device
from ..models.backbone import (BLOCK_STRIDES, _basic, input_norm,
                               stem_unfused, xfeat_forward)
from ..ops.cuda.bicubic import sample_descriptors
from ..ops.cuda.detect_fused import topk_keypoints_fused
from ..ops.cuda.stem_fused import stem_fused
from ..ops.detect import heatmap_decode
from ..ops.extraction import detect_and_compute
from ..ops.resize import to_unit_float
from ..utils.profiling import scan_time, speed_of_light
from .eval_slam import device_label

THRESHOLD = 0.05
# the blocks at /8 after the pyramid, every conv at stride 1
HEADS = ("block_fusion", "heatmap_head", "keypoint_head")


def conv_cost(b: int, hi: int, wi: int, w: torch.Tensor, stride: int,
              dsz: int) -> Tuple[float, float, int, int]:
    """(flops, bytes, ho, wo) of one conv of weight w (O, I, k, k) at
    stride `stride` on a (b, I, hi, wi) input: 2 flops a multiply-add,
    the input read and the output written once in `dsz`-byte elements."""
    cout, cin, k, _ = w.shape
    ho, wo = hi // stride, wi // stride
    flops = 2.0 * b * ho * wo * k * k * cin * cout
    nbytes = float(b) * (hi * wi * cin + ho * wo * cout) * dsz
    return flops, nbytes, ho, wo


def block_cost(params: Dict[str, Any], name: str, strides: List[int],
               b: int, hi: int, wi: int, dsz: int
               ) -> Tuple[float, float, int, int]:
    """(flops, bytes, ho, wo) of a block's convs in turn, each at its
    stride in `strides` or, past its end (a final plain conv), at 1."""
    fl = by = 0.0
    layers = params[name]
    for i, p in enumerate(layers):
        f, n, hi, wi = conv_cost(b, hi, wi, p["w"],
                                 strides[i] if i < len(strides) else 1, dsz)
        fl, by = fl + f, by + n
    return fl, by, hi, wi


def stage_costs(params: Dict[str, Any], b: int, h: int, w: int, k: int,
                dsz: int) -> Dict[str, Tuple[float, float]]:
    """{stage: (flops, bytes)} of one batch of b (h, w) images at top_k
    k, the convolutions in `dsz`-byte elements."""
    sk_f, sk_b, _, _ = conv_cost(b, h // 4, w // 4, params["skip1"]["w"], 1,
                                 dsz)
    st_f, st_b, hi, wi = block_cost(params, "block1", BLOCK_STRIDES["block1"],
                                    b, h, w, dsz)
    stem = (st_f + sk_f, st_b + sk_b)
    fl, by = stem
    for name in ("block2", "block3", "block4", "block5"):
        f, n, hi, wi = block_cost(params, name, BLOCK_STRIDES[name], b, hi,
                                  wi, dsz)
        fl, by = fl + f, by + n
    h8, w8 = h // 8, w // 8
    for name in HEADS:
        f, n, _, _ = block_cost(params, name, [], b, h8, w8, dsz)
        fl, by = fl + f, by + n
    by += 4.0 * b * h8 * w8 * 64 * dsz   # two bilinear ups + the fusion sum
    n = b * h * w
    costs = {
        "input_norm": (0.0, 3.0 * n * 4),
        "stem": stem,
        "backbone": (fl, by),
        "decode": (0.0, 3.0 * n * 4),
        # kernel A's function: heatmap and reliability read, keypoints
        # (int64 xy) and scores written; ~40 operations a pixel
        "detect": (40.0 * n, 4.0 * (n + n // 64) + 20.0 * b * k),
        # kernel B's function: the raw map and the keypoints read, the
        # descriptors written; per tap channel a square, a sum, a division,
        # a weight and a sum, then the final norm
        "bicubic": (b * k * (16 * 64 * 5 + 64 * 3),
                    4.0 * (b * h8 * w8 * 64 + b * k * 2 + b * k * 64)),
    }
    costs["full"] = tuple(map(sum, zip(*(costs[s] for s in (
        "input_norm", "backbone", "decode", "detect", "bicubic")))))
    return costs


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=str, default="640x480")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--input_dtype", type=str, default="float32",
                    choices=["float32", "uint8"],
                    help="uint8 = camera-native frames (the /255 runs "
                         "inside the pipeline)")
    ap.add_argument("--channels", type=int, default=1, choices=[1, 3])
    ap.add_argument("--fused_stem", action="store_true",
                    help="also time the fused stem kernel, and run the "
                         "backbone and the full pipeline with it")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    W, H = map(int, args.res.split("x"))
    B, K = args.batch, args.top_k
    cdt = getattr(torch, args.dtype)
    fused = args.fused_stem
    params = XFeat(None, top_k=K, detection_threshold=THRESHOLD,
                   device=device).model.params
    rng = np.random.default_rng(0)
    shape = (B, H, W, args.channels)
    x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)
                         if args.input_dtype == "uint8" else
                         rng.uniform(0, 1, shape).astype(np.float32)
                         ).to(device)
    label = device_label(device)

    def path(kernel):   # what runs a kernel's stage on this device
        return f"kernel {kernel}" if device.type == "cuda" else "plain"
    print(f"# device={label} B={B} {W}x{H} top_k={K} dtype={args.dtype} "
          f"input={args.input_dtype} fused_stem={fused}", flush=True)

    def stage(name, fn, *inputs):
        with torch.inference_mode():
            t = scan_time(fn, *inputs, perturb_ints=True)
        print(f"[stage] {name}: {t * 1e3:.3f} ms/batch", flush=True)
        return t

    t_full = stage("full", lambda im: detect_and_compute(
        params, im, K, THRESHOLD, cdt, fused), x)
    t_bb = stage("backbone", lambda im: xfeat_forward(
        params, to_unit_float(im), compute_dtype=cdt, fused_stem=fused), x)

    def normed(im):
        return input_norm(to_unit_float(im)).to(cdt)
    t_in = stage("input_norm", normed, x)
    t_stem = stage("stem", lambda im: stem_unfused(params, normed(im)), x)
    t_stem_e = stage(f"stem ({path('E')})", lambda im: stem_fused(
        params, normed(im)), x) if fused else None
    with torch.inference_mode():
        zs = [normed(x)]
        for p, s in zip(params["block1"], BLOCK_STRIDES["block1"]):
            zs.append(_basic(p, zs[-1], s))
        feats, logits, heat = xfeat_forward(params, to_unit_float(x),
                                            compute_dtype=cdt,
                                            fused_stem=fused)
        kheat = heatmap_decode(logits.float())
        rel = heat[..., 0].float().contiguous()
        maps = feats.float().contiguous()
    t_convs = [stage(f"block1.conv{i + 1}",
                     lambda z, p=p, s=s: _basic(p, z, s), zs[i])
               for i, (p, s) in enumerate(zip(params["block1"],
                                              BLOCK_STRIDES["block1"]))]
    t_decode = stage("heatmap_decode", heatmap_decode, logits.float())
    # the wrappers ops/extraction calls: kernels A and B on the card, their
    # plain versions on the CPU
    t_detect = stage(f"detect ({path('A')})",
                     lambda kh, r: topk_keypoints_fused(kh, r, K, THRESHOLD),
                     kheat, rel)
    kpts = torch.from_numpy((rng.uniform(0, 1, (B, K, 2))
                             * [W - 1, H - 1]).astype(np.float32)).to(device)
    t_samp = stage(f"bicubic ({path('B')})", lambda m, kp: sample_descriptors(
        m, kp, (H, W)), maps, kpts)

    dsz = 2 if cdt == torch.bfloat16 else 4
    conv_peak = "bf16" if cdt == torch.bfloat16 else "f32"
    costs = stage_costs(params, B, H, W, K, dsz)
    rows: List[Tuple[str, float, Optional[str], str]] = [
        ("input_norm", t_in, "input_norm", "f32")]
    for i, (p, s) in enumerate(zip(params["block1"],
                                   BLOCK_STRIDES["block1"])):
        cout, cin = p["w"].shape[:2]
        rows.append((f"block1.conv{i + 1} {cin}->{cout} s{s}", t_convs[i],
                     None, conv_peak))
    rows.append(("stem total (IN+block1+skip, convs)", t_stem, "stem",
                 conv_peak))
    if fused:
        rows.append((f"stem total ({path('E')})", t_stem_e, "stem",
                     conv_peak))
    rows += [("backbone total", t_bb, "backbone", conv_peak),
             (f"nms+score+topk ({path('A')})", t_detect, "detect", "f32"),
             ("heatmap_decode", t_decode, "decode", "f32"),
             (f"bicubic sample+norm ({path('B')})", t_samp, "bicubic",
              "f32"),
             ("FULL detect_and_compute", t_full, "full", conv_peak)]
    print(f"{'stage':<36}{'ms/batch':>10}{'us/frame':>10}{'% of full':>10}"
          f"{'SoL ms':>10}{'SoL %':>7}", flush=True)
    out = []
    for name, t, key, peak in rows:
        row = {"stage": name, "ms": t * 1e3, "us_per_frame": t * 1e6 / B,
               "pct_of_full": 100.0 * t / t_full, "sol_ms": None,
               "sol_pct": None, "device": label}
        extra = ""
        if key is not None:
            fl, by = costs[key]
            s = speed_of_light(t, flops=fl, bytes_moved=by, dtype=peak)
            row["sol_ms"] = s["sol_seconds"] * 1e3
            row["sol_pct"] = 100.0 * s["sol_frac"]
            extra = f"{row['sol_ms']:>10.4f}{row['sol_pct']:>6.1f}%"
        print(f"{name:<36}{row['ms']:>10.3f}{row['us_per_frame']:>10.1f}"
              f"{row['pct_of_full']:>9.1f}%{extra}", flush=True)
        out.append(row)
    print(f"FPS: {B / t_full:.0f} on {label}", flush=True)
    return out


if __name__ == "__main__":
    main()
