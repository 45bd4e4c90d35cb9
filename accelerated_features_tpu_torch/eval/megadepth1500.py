"""MegaDepth-1500 relative-pose benchmark harness (counterpart of the JAX
package's `eval/megadepth1500.py`).

Protocol of the original XFeat evaluation:
  * pairs described by a JSON file (T_0to1, K0, K1, optional
    /32-divisible resized sizes and keypoint scales);
  * a matcher produces pixel correspondences; keypoints are rescaled from
    the resized eval resolution back to the intrinsics' frame;
  * pose from an essential-matrix RANSAC, max_epipolar_error 2.5 px,
    success_prob 0.99999: by default the native 5-point LO-RANSAC
    (`pose_backend="posekit"`, `geometry/pose.py`, as in the JAX
    package), or the batched-hypothesis 8-point MSAC of
    `geometry/ransac.py` on the device (`pose_backend="gpu"`);
  * metric: AUC@{5,10,20} of max(angular R err, angular t err) + mAcc.

Run on the committed rendered holdout (150 pairs, 800x608):

    python -m accelerated_features_tpu_torch.eval.megadepth1500 \
        --data_root artifacts/rendered_pose_holdout \
        --json artifacts/rendered_pose_holdout/rendered_pose_pairs.json \
        --matcher xfeat --weights artifacts/run_md_ckpt13250.npz \
        --top_k 2048 --limit 100 [--pose_backend gpu] [--device cpu]

Reading images needs `cv2`, imported only by the functions that read.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..geometry import get_pose_estimator
from .metrics import pose_errors_to_summary, relative_pose_error

# the committed rendered holdout's manifest
DEFAULT_JSON = str(Path(__file__).resolve().parents[2] / "artifacts"
                   / "rendered_pose_holdout" / "rendered_pose_pairs.json")

Device = Optional[Union[str, torch.device]]
MatcherFn = Callable[[np.ndarray, np.ndarray],
                     Tuple[np.ndarray, np.ndarray]]


def load_pairs(json_path: str = DEFAULT_JSON) -> List[dict]:
    with open(json_path) as f:
        return json.load(f)


def _resize_pair_images(im0, im1, pair, cv2):
    """Resize to the stored eval sizes (`size0_hw`, (h, w)) and return the
    stored keypoint -> intrinsics scale factors (`scale0`, `scale1`)."""
    out = []
    scales = []
    for im, size_key, scale_key in [(im0, "size0_hw", "scale0"),
                                    (im1, "size1_hw", "scale1")]:
        hw = pair.get(size_key)
        if hw is not None:
            im = cv2.resize(im, (int(hw[1]), int(hw[0])))
        sc = pair.get(scale_key)
        scales.append(tuple(sc) if sc is not None else (1.0, 1.0))
        out.append(im)
    return out[0], out[1], scales[0], scales[1]


def compute_pose_error(pair: dict, mkpts0: np.ndarray, mkpts1: np.ndarray,
                       scale0=(1.0, 1.0), scale1=(1.0, 1.0),
                       ransac_thr: float = 2.5, pose_backend: str = "posekit",
                       device: Device = None) -> Dict[str, float]:
    """Rescale matches to the intrinsics' resolution, estimate the pose,
    return the angular errors. `pose_backend`: "posekit", the native
    5-point LO-RANSAC on the host, or "gpu", the batched 8-point MSAC on
    `device` (None: the GPU)."""
    K0 = np.asarray(pair["K0"], np.float64)
    K1 = np.asarray(pair["K1"], np.float64)
    T_0to1 = np.asarray(pair["T_0to1"], np.float64)

    mkpts0 = np.asarray(mkpts0, np.float64) * np.asarray(scale0)
    mkpts1 = np.asarray(mkpts1, np.float64) * np.asarray(scale1)

    err = {"R_err": 180.0, "t_err": 180.0, "n_matches": len(mkpts0),
           "n_inliers": 0}
    if len(mkpts0) < 5:
        return err
    res = get_pose_estimator(pose_backend, device)(
        mkpts0, mkpts1, K0, K1, max_epipolar_error=ransac_thr,
        success_prob=0.99999)
    if res is None:
        return err
    R, t, mask = res
    err.update(relative_pose_error(T_0to1, R, t))
    err["n_inliers"] = int(mask.sum())
    return err


def _summary(errors: List[Dict[str, float]]) -> Dict[str, float]:
    summary = pose_errors_to_summary(errors)
    summary["mean_matches"] = float(np.mean([e["n_matches"] for e in errors]))
    summary["mean_inliers"] = float(np.mean([e["n_inliers"] for e in errors]))
    return summary


def run_benchmark(matcher_fn: MatcherFn, data_root: str,
                  json_path: str = DEFAULT_JSON, ransac_thr: float = 2.5,
                  limit: Optional[int] = None, progress: bool = True,
                  pose_backend: str = "posekit", device: Device = None
                  ) -> Dict[str, float]:
    """Image-based benchmark, one pair at a time (needs the images under
    `data_root` and `cv2`)."""
    import cv2
    pairs = load_pairs(json_path)
    if limit:
        pairs = pairs[:limit]
    errors = []
    it: Iterable = pairs
    if progress:
        try:
            import tqdm
            it = tqdm.tqdm(pairs, desc="[MegaDepth-1500]")
        except ImportError:
            pass
    for pair in it:
        im0 = cv2.imread(os.path.join(data_root, pair["pair_names"][0]))
        im1 = cv2.imread(os.path.join(data_root, pair["pair_names"][1]))
        if im0 is None or im1 is None:
            raise FileNotFoundError(pair["pair_names"])
        im0, im1, sc0, sc1 = _resize_pair_images(im0, im1, pair, cv2)
        mk0, mk1 = matcher_fn(im0, im1)
        errors.append(compute_pose_error(pair, mk0, mk1, sc0, sc1,
                                         ransac_thr, pose_backend, device))
    return _summary(errors)


def run_benchmark_batched(data_root: str, json_path: str = DEFAULT_JSON,
                          top_k: int = 4096, weights: Optional[str] = None,
                          batch_size: int = 8, ransac_thr: float = 2.5,
                          limit: Optional[int] = None, progress: bool = True,
                          pose_backend: str = "posekit",
                          detection_threshold: float = 0.05,
                          compute_dtype: Optional[torch.dtype] = None,
                          fused_stem: bool = False, device: Device = None
                          ) -> Dict[str, float]:
    """Batched sparse (MNN) benchmark: buckets the eval images by their
    stored size, runs batched `detect_and_compute` per bucket and the
    batched masked MNN over the pairs; resize, rescale, thresholds and
    metric are those of `run_benchmark`. `weights` None is the
    repository's trained extractor."""
    from ..api import DEFAULT_WEIGHTS, XFeat
    from .batched import extract_features_batched, match_pairs_batched

    xf = XFeat(weights or DEFAULT_WEIGHTS, top_k, detection_threshold, device)
    pairs = load_pairs(json_path)
    if limit:
        pairs = pairs[:limit]

    # dedup images by (path, eval size): pairs reuse images, so extracting
    # per (pair, side) would repeat the same forward several-fold
    scales: List[list] = [[(1.0, 1.0), (1.0, 1.0)] for _ in pairs]
    uniq: Dict[tuple, tuple] = {}
    side_key: List[list] = [[None, None] for _ in pairs]
    for i, pair in enumerate(pairs):
        for side in (0, 1):
            sc = pair.get(f"scale{side}")
            if sc is not None:
                scales[i][side] = tuple(sc)
            hw = pair.get(f"size{side}_hw")
            key = (pair["pair_names"][side],
                   tuple(int(x) for x in hw) if hw is not None else None)
            uniq[key] = (key, key[0], hw)
            side_key[i][side] = key

    feats = extract_features_batched(
        xf.model.params, list(uniq.values()), data_root, top_k,
        detection_threshold, compute_dtype, batch_size, progress,
        tag="MegaDepth-1500 batched", fused_stem=fused_stem)
    matches = match_pairs_batched(
        feats, [(side_key[i][0], side_key[i][1])
                for i in range(len(pairs))], batch_size, device=xf.device)

    errors = [compute_pose_error(pairs[i], matches[i][0], matches[i][1],
                                 scales[i][0], scales[i][1], ransac_thr,
                                 pose_backend, xf.device)
              for i in range(len(pairs))]
    return _summary(errors)


def run_benchmark_precomputed(matches: List[Tuple[np.ndarray, np.ndarray]],
                              pairs: List[dict], ransac_thr: float = 2.5,
                              pose_backend: str = "posekit",
                              device: Device = None) -> Dict[str, float]:
    """Benchmark from precomputed correspondences (tests, cached runs)."""
    errors = [compute_pose_error(pair, mk0, mk1, ransac_thr=ransac_thr,
                                 pose_backend=pose_backend, device=device)
              for (mk0, mk1), pair in zip(matches, pairs)]
    return pose_errors_to_summary(errors)


def make_matcher(name: str, top_k: int = 4096, weights: Optional[str] = None,
                 lg_weights: Optional[str] = None, lg_min_conf: float = 0.1,
                 device: Device = None, **xfeat_options) -> MatcherFn:
    """Matcher registry: xfeat | xfeat-star | xfeat-lighterglue, each a
    function of two images returning numpy correspondences. `weights` None
    is the repository's trained extractor. `lg_weights` loads the
    LighterGlue `.npz` (None opts into random weights with a warning);
    `lg_min_conf` is its confidence gate. Further keywords
    (`compute_dtype`, `fused_stem`, `fused_matching`) go to `XFeat`."""
    from ..api import DEFAULT_WEIGHTS, XFeat
    xf = XFeat(weights or DEFAULT_WEIGHTS, top_k=top_k, device=device,
               **xfeat_options)
    if name == "xfeat":
        return lambda im0, im1: xf.match_xfeat(im0, im1)
    if name == "xfeat-star":
        return lambda im0, im1: xf.match_xfeat_star(im0, im1)
    if name == "xfeat-lighterglue":
        xf.set_lighterglue(weights=lg_weights)

        def fn(im0, im1):
            d0 = xf.detectAndCompute(im0)[0]
            d1 = xf.detectAndCompute(im1)[0]
            d0["image_size"] = (im0.shape[1], im0.shape[0])
            d1["image_size"] = (im1.shape[1], im1.shape[0])
            mk0, mk1, _ = xf.match_lighterglue(d0, d1, min_conf=lg_min_conf)
            return mk0.cpu().numpy(), mk1.cpu().numpy()
        return fn
    raise ValueError(f"unknown matcher {name}")


def main():
    ap = argparse.ArgumentParser(description="MegaDepth-1500 pose benchmark")
    ap.add_argument("--data_root", type=str, required=True,
                    help="dir containing the pairs' images")
    ap.add_argument("--json", type=str, default=DEFAULT_JSON)
    ap.add_argument("--matcher", type=str, default="xfeat",
                    choices=["xfeat", "xfeat-star", "xfeat-lighterglue"])
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--lg_weights", type=str, default=None,
                    help="LighterGlue checkpoint (.npz) for the "
                         "xfeat-lighterglue matcher")
    ap.add_argument("--lg_min_conf", type=float, default=0.1,
                    help="LighterGlue confidence gate")
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--ransac_thr", type=float, default=2.5)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--pose_backend", type=str, default="posekit",
                    choices=["posekit", "gpu"],
                    help="posekit: native 5-pt LO-RANSAC on the host; gpu: "
                         "batched 8-pt MSAC on the device")
    ap.add_argument("--batched", action="store_true",
                    help="size-bucketed batched extraction + batched MNN "
                         "(sparse xfeat only; identical protocol)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--compute_dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--fused_stem", action="store_true",
                    help="run the backbone's stem as the fused kernel")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args()

    if args.batched:
        if args.matcher != "xfeat":
            ap.error("--batched supports the sparse 'xfeat' matcher")
        summary = run_benchmark_batched(
            args.data_root, args.json, top_k=args.top_k,
            weights=args.weights, batch_size=args.batch_size,
            ransac_thr=args.ransac_thr, limit=args.limit,
            pose_backend=args.pose_backend,
            compute_dtype=getattr(torch, args.compute_dtype),
            fused_stem=args.fused_stem, device=args.device)
    else:
        fn = make_matcher(args.matcher, args.top_k, args.weights,
                          lg_weights=args.lg_weights,
                          lg_min_conf=args.lg_min_conf, device=args.device,
                          compute_dtype=args.compute_dtype,
                          fused_stem=args.fused_stem)
        summary = run_benchmark(fn, args.data_root, args.json,
                                args.ransac_thr, args.limit,
                                pose_backend=args.pose_backend,
                                device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
