"""Held-out synthetic homography benchmark, the offline AUC proxy
(counterpart of the JAX package's `apps/eval_synthetic.py`).

Known-homography pairs from held-out images, scored end to end through
the user path (a matcher of `XFeat`, then posekit's LO-RANSAC
homography):

  * match precision @3 px under the true homography,
  * matches per pair,
  * homography success, mean corner error (MACE) and AUC@{3,5,10} px of
    the corner error.

The second image of a pair is the first warped by a seeded random
homography (`gt_homography`) through `utils/imageio.warp_perspective`,
`cv2.warpPerspective` without cv2. Every row carries the device's name
and, on the card, its power limit:

    python -m accelerated_features_tpu_torch.apps.eval_synthetic \\
        --images DIR [--ckpt CKPT[,CKPT...]] [--pairs 100] [--top_k 2048] \\
        [--matcher mnn|star|lighterglue] [--lg_weights W] [--json OUT] \\
        [--device cpu]

`DIR` is searched for `*.png` and `*.jpg` (not recursively). No
`--ckpt` evaluates a random extractor. The device defaults to the GPU
and the run raises without one.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..api import XFeat, resolve_device
from ..eval.metrics import error_auc
from ..geometry.pose import estimate_homography
from ..utils.checkpoint import checkpoint_params_tree
from ..utils.imageio import imread_if_image, warp_perspective
from .eval_slam import device_label


def gt_homography(rng: np.random.Generator, w: int, h: int,
                  difficulty: float = 0.25) -> np.ndarray:
    """Random projective warp around the image center (the JAX package's
    generator, draw for draw)."""
    ang = rng.uniform(-30, 30) * np.pi / 180
    sc = rng.uniform(0.8, 1.25)
    tx, ty = rng.uniform(-0.08, 0.08, 2) * [w, h]
    px, py = rng.uniform(-1e-4, 1e-4, 2) * difficulty * 4
    shear = rng.uniform(-0.15, 0.15)
    c, s = np.cos(ang), np.sin(ang)
    T0 = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1]])
    # shear perturbs one off-diagonal only, as the JAX generator does
    A = np.array([[sc * c, sc * (shear - s), tx],
                  [sc * s, sc * c, ty],
                  [px, py, 1.0]])
    T1 = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1]])
    return T1 @ A @ T0


def corner_error(H_est: np.ndarray, H_gt: np.ndarray, w: int, h: int
                 ) -> float:
    """Mean distance between the image corners mapped by both
    homographies."""
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)

    def warp(H, p):
        ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ H.T
        return ph[:, :2] / ph[:, 2:]

    return float(np.mean(np.linalg.norm(warp(H_est, corners) -
                                        warp(H_gt, corners), axis=1)))


def synthetic_pairs(paths: List[str], n_pairs: int, seed: int
                    ) -> Iterator[Tuple[str, Optional[np.ndarray],
                                        Optional[np.ndarray],
                                        Optional[np.ndarray]]]:
    """The benchmark's pairs: (path, image, its warp, true homography) for
    pair i of `n_pairs`, image i modulo the list, the homographies drawn
    from one generator of `seed`; (path, None, None, None) for a file
    that is not a PNG or JPEG."""
    rng = np.random.default_rng(seed)
    for i in range(n_pairs):
        path = paths[i % len(paths)]
        im0 = imread_if_image(path)
        if im0 is None:
            yield path, None, None, None
            continue
        h, w = im0.shape[:2]
        H_gt = gt_homography(rng, w, h)
        yield path, im0, warp_perspective(im0, H_gt, (w, h)), H_gt


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=str, required=True)
    ap.add_argument("--ckpt", type=str, default=None,
                    help="training checkpoint dir/file; None = random "
                         "init. A comma-separated list sweeps several "
                         "checkpoints in one process (XFeat.set_params); "
                         "the literal 'random' is a random-init row")
    ap.add_argument("--pairs", type=int, default=100)
    ap.add_argument("--top_k", type=int, default=2048)
    ap.add_argument("--detection_threshold", type=float, default=None,
                    help="default: 0.012 for random init, 0.05 trained")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    ap.add_argument("--matcher", type=str, default="mnn",
                    choices=["mnn", "star", "lighterglue"],
                    help="mnn: match_xfeat; star: semi-dense "
                         "match_xfeat_star; lighterglue: attention "
                         "matcher (needs --lg_weights)")
    ap.add_argument("--lg_weights", type=str, default=None,
                    help="LighterGlue weights (.npz/.pt or a "
                         "lighterglue_run checkpoint dir)")
    ap.add_argument("--lg_min_conf", type=str, default="0.1",
                    help="comma-separated confidence gates to sweep for "
                         "--matcher lighterglue; each is one row")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    label = device_label(device)
    ckpts = [c.strip() for c in args.ckpt.split(",")] if args.ckpt \
        else [None]
    ckpts = [None if c in ("", "random") else c for c in ckpts]

    def ckpt_params(ckpt):
        return None if ckpt is None else checkpoint_params_tree(ckpt)

    def ckpt_thr(ckpt):
        if args.detection_threshold is not None:
            return args.detection_threshold
        return 0.05 if ckpt else 0.012

    xf = XFeat(ckpt_params(ckpts[0]), top_k=args.top_k,
               detection_threshold=ckpt_thr(ckpts[0]), device=device)
    if args.matcher == "lighterglue":
        if not args.lg_weights:
            raise SystemExit("--matcher lighterglue needs --lg_weights "
                             "(pass 'random' to smoke-test random weights)")
        xf.set_lighterglue(None if args.lg_weights == "random"
                           else args.lg_weights)

    def run_matcher(im0, im1, lg_min_conf):
        if args.matcher == "mnn":
            return xf.match_xfeat(im0, im1)
        if args.matcher == "star":
            return xf.match_xfeat_star(im0, im1)
        d0 = xf.detectAndCompute(im0)[0]
        d0["image_size"] = im0.shape[1::-1]
        d1 = xf.detectAndCompute(im1)[0]
        d1["image_size"] = im1.shape[1::-1]
        mk0, mk1, _ = xf.match_lighterglue(d0, d1, min_conf=lg_min_conf)
        return mk0.cpu().numpy(), mk1.cpu().numpy()

    paths = sorted(glob.glob(os.path.join(args.images, "*.png")) +
                   glob.glob(os.path.join(args.images, "*.jpg")))
    if not paths:
        raise FileNotFoundError(args.images)

    def eval_one(ckpt, lg_min_conf):
        # the same seed for every row: every row sees the same pairs
        prec, nm, mace, ok = [], [], [], 0
        for path, im0, im1, H_gt in synthetic_pairs(paths, args.pairs,
                                                    args.seed):
            if im0 is None:
                print(f"[eval_synthetic] unreadable image skipped: {path}")
                prec.append(0.0)
                nm.append(0)
                continue
            h, w = im0.shape[:2]
            mk0, mk1 = run_matcher(im0, im1, lg_min_conf)
            nm.append(len(mk0))
            if len(mk0) >= 4:
                ph = np.concatenate([mk0, np.ones((len(mk0), 1))], 1) @ H_gt.T
                proj = ph[:, :2] / ph[:, 2:]
                err = np.linalg.norm(proj - mk1, axis=1)
                prec.append(float(np.mean(err < 3.0)))
                res = estimate_homography(mk0, mk1, thresh=4.0)
                if res is not None:
                    ok += 1
                    mace.append(corner_error(res[0], H_gt, w, h))
            else:
                prec.append(0.0)

        mace_arr = np.asarray(mace) if mace else np.asarray([1e9])
        # pairs with no homography count as infinite error
        errors_full = list(mace) + [np.inf] * (args.pairs - len(mace))
        a = error_auc(errors_full, thresholds=(3, 5, 10))
        row = {
            "ckpt": ckpt or "random-init",
            "matcher": args.matcher,
            "pairs": args.pairs,
            "seed": args.seed,
            "detection_threshold": xf.detection_threshold,
            "mean_matches": float(np.mean(nm)),
            "precision@3px": float(np.mean(prec)),
            "homography_success": ok / args.pairs,
            "mace_median_px": float(np.median(mace_arr)),
            **{f"h_auc@{t}px": a[f"auc@{t}"] for t in (3, 5, 10)},
        }
        if args.matcher == "lighterglue":
            row["lg_min_conf"] = lg_min_conf
        row["device"] = label
        return row

    lg_confs = [float(c) for c in args.lg_min_conf.split(",")] \
        if args.matcher == "lighterglue" else [0.1]
    results = []
    for j, ckpt in enumerate(ckpts):
        if j > 0:     # the first checkpoint was loaded at construction
            xf.set_params(ckpt_params(ckpt))
            xf.detection_threshold = ckpt_thr(ckpt)
        for mc in lg_confs:
            out = eval_one(ckpt, mc)
            print(json.dumps(out, indent=2), flush=True)
            results.append(out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f,
                      indent=2)
    return results


if __name__ == "__main__":
    main()
