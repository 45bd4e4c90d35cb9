"""A/B of the decode and selection stages on the card (counterpart of the
JAX package's `apps/measure_select.py`).

    python -m accelerated_features_tpu_torch.tools.measure_select \\
        [--batch 64] [--iters 20] [--top_k 4096] \\
        [--shapes 640x480,1024x768] [--skip_e2e] [--device cpu]

For each shape, at batch B, with logits ~ N(0, 2) and reliability ~
U(0, 1) drawn as the JAX probe draws them (one `default_rng(0)` over the
shapes):
  1. the three decodes of `ops/detect.py` (reshape, conv_transpose,
     planes), each holding the reshape form's bits;
  2. the selection: kernel A's candidate kernel alone
     (`detect_candidates`), A's whole stage (`topk_keypoints_fused`:
     candidates then the exact selection), `torch.topk` finishing A's
     candidates, and the plain chain (`score_map` + `topk_keypoints`);
     A's keypoints must equal the plain chain's, and the `torch.topk`
     finish must select the same keypoints;
  3. end to end, the sparse extraction composed from the port's functions
     in bfloat16 with the trained extractor on seeded uint8 images: each
     decode with kernels A and B, then kernel A against the plain
     selection chain and kernel B against the plain sampler
     (`plain_descriptors`). The composition with the reshape decode, A and
     B must equal `ops/extraction.detect_and_compute` under `torch.equal`.
Each line is one JSON object: the stage, the variant, the shape, the
steady-state ms a batch (`utils/profiling.scan_time`: inputs perturbed
every iteration) and the device with the card's power limit. The device
defaults to the card and the run raises without one; on the CPU
(`--device cpu`) the kernels' plain versions run in their place.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from ..api import resolve_device
from ..apps.eval_slam import device_label
from ..models.backbone import xfeat_forward
from ..ops import detect as D
from ..ops.cuda.bicubic import plain_descriptors, sample_descriptors
from ..ops.cuda.detect_fused import detect_candidates, topk_keypoints_fused
from ..ops.extraction import detect_and_compute
from ..ops.resize import preprocess_image, to_unit_float
from ..utils.profiling import scan_time

ROOT = Path(__file__).resolve().parents[2]
WEIGHTS = ROOT / "artifacts" / "run_md_ckpt13250.npz"
THR = 0.05


def emit(**kw) -> Dict:
    print(json.dumps(kw), flush=True)
    return kw


def topk_finish(best: torch.Tensor, sub: torch.Tensor, top_k: int):
    """`torch.topk` selecting keypoints from 2x2-tile candidates, decoded
    as `ops.detect.select_keypoints` decodes them (the order among equal
    scores is torch.topk's)."""
    b, h2, w2 = best.shape
    scores, idx = torch.topk(best.reshape(b, -1), min(top_k, h2 * w2))
    s = torch.gather(sub.reshape(b, -1), 1, idx).long()
    return torch.stack([(idx % w2) * 2 + s % 2, (idx // w2) * 2 + s // 2],
                       -1), scores


def plain_select(kheat, rel, top_k, thr):
    return D.topk_keypoints(D.score_map(kheat, rel, thr), top_k)


def extract(params, images, top_k: int, decode: Callable = D.heatmap_decode,
            select: Callable = topk_keypoints_fused,
            sample: Callable = sample_descriptors,
            compute_dtype: torch.dtype = torch.bfloat16):
    """`detect_and_compute`'s sparse extraction with its decode, selection
    and sampling stages given."""
    x, rh, rw = preprocess_image(to_unit_float(images))
    H, W = x.shape[1], x.shape[2]
    feats, logits, heat = xfeat_forward(params, x, compute_dtype=compute_dtype)
    kpts_i, scores = select(decode(logits.float()),
                            heat[..., 0].float().contiguous(), top_k, THR)
    kpts_f = kpts_i.float()
    descs = sample(feats.float(), kpts_f, (H, W))
    kpts = kpts_f * torch.tensor([rw, rh], dtype=torch.float32,
                                 device=kpts_f.device)
    return {"keypoints": kpts, "scores": scores, "descriptors": descs,
            "valid": scores > 0}


def _valid_sets(kpts, scores):
    return [{tuple(p) for p, s in zip(k.tolist(), sc.tolist()) if s > 0}
            for k, sc in zip(kpts.cpu(), scores.cpu())]


def run(args, device: torch.device) -> List[Dict]:
    label = device_label(device)
    rng = np.random.default_rng(0)
    B, K = args.batch, args.top_k
    out = []

    def timed(fn, *a, perturb_ints=False):
        with torch.inference_mode():
            return scan_time(fn, *a, iters=args.iters,
                             perturb_ints=perturb_ints) * 1e3

    for shape in args.shapes.split(","):
        W, H = map(int, shape.split("x"))
        h, w = H // 8, W // 8
        logits = torch.from_numpy(rng.normal(0, 2, (B, h, w, 65)).astype(
            np.float32)).to(device)
        rel = torch.from_numpy(rng.uniform(0, 1, (B, h, w)).astype(
            np.float32)).to(device)
        row = {"shape": shape, "batch": B, "top_k": K, "device": label}

        # ---- the decodes ---------------------------------------------------
        with torch.inference_mode():
            kheat = D.heatmap_decode(logits)
        for impl in D.DECODE_VARIANTS:
            with torch.inference_mode():
                same = torch.equal(D.heatmap_decode_auto(logits, impl=impl),
                                   kheat)
            if not same:
                raise AssertionError(f"decode {impl} differs from reshape")
            out.append(emit(stage="decode", variant=impl, **row,
                            ms_per_batch=timed(
                                lambda x, i=impl: D.heatmap_decode_auto(
                                    x, impl=i), logits)))

        # ---- the selection -------------------------------------------------
        with torch.inference_mode():
            best, sub = detect_candidates(kheat, rel, THR)
            ref = plain_select(kheat, rel, K, THR)
            got = topk_keypoints_fused(kheat, rel, K, THR)
            fin = topk_finish(best, sub, K)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError("kernel A differs from the plain chain")
        if _valid_sets(*fin) != _valid_sets(*got):
            raise AssertionError("torch.topk's finish selects other "
                                 "keypoints than kernel A")
        n_valid = int((got[1] > 0).sum()) / B
        cand = timed(lambda kh, r: detect_candidates(kh, r, THR), kheat, rel)
        out.append(emit(stage="select", variant="a_candidates", **row,
                        ms_per_batch=cand, keypoints_per_image=n_valid))
        for name, fn in (
                ("a_stage", lambda kh, r: topk_keypoints_fused(kh, r, K,
                                                               THR)),
                ("a_candidates+torch.topk",
                 lambda kh, r: topk_finish(*detect_candidates(kh, r, THR),
                                           K)),
                ("plain_chain", lambda kh, r: plain_select(kh, r, K, THR))):
            ms = timed(fn, kheat, rel)
            out.append(emit(stage="select", variant=name, **row,
                            ms_per_batch=ms,
                            finisher_ms=None if name == "plain_chain"
                            else ms - cand))

        # ---- end to end ----------------------------------------------------
        if args.skip_e2e:
            continue
        params = extractor_params(args.weights, device)
        images = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3)).astype(
            np.uint8)).to(device)
        with torch.inference_mode():
            a = extract(params, images, K)
            b = detect_and_compute(params, images, K, THR, torch.bfloat16)
        if not all(torch.equal(a[k], b[k]) for k in b):
            raise AssertionError("the composed extraction differs from "
                                 "detect_and_compute")
        n_valid = float(a["valid"].float().sum(1).mean())
        variants = [(f"decode={impl}", {"decode": fn})
                    for impl, fn in D.DECODE_VARIANTS.items()]
        variants += [("select=plain_chain", {"select": plain_select}),
                     ("sample=plain", {"sample": plain_descriptors})]
        for name, kw in variants:
            ms = timed(lambda p, x: extract(p, x, K, **kw), params, images,
                       perturb_ints=True)
            out.append(emit(stage="e2e", variant=name, **row,
                            ms_per_batch=ms, fps=B / ms * 1e3,
                            keypoints_per_image=n_valid))
    return out


def extractor_params(weights: str, device: torch.device):
    """The folded extractor tree on `device`: `weights`, or the random one
    of `XFeat(weights=None)` for "random"."""
    from ..api import XFeat
    return XFeat(weights=None if weights == "random" else weights,
                 device=device).model.params


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--shapes", type=str, default="640x480,1024x768")
    ap.add_argument("--skip_e2e", action="store_true")
    ap.add_argument("--weights", default=str(WEIGHTS),
                    help="the extractor of the end-to-end rows ('random': "
                         "the JAX probe's random weights, which select "
                         "nothing at threshold 0.05)")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
