"""End-to-end SLAM/ATE benchmark on a rendered ground-truth trajectory
(counterpart of the JAX package's `apps/eval_slam.py`).

Renders a smooth orbit through a procedural scene textured with crops of
the PNGs under `--textures` (`train/render.render_trajectory`: exact K and
world-to-camera poses), runs the tracker with the port's XFeat front end
(extraction -> MNN matching -> LO-RANSAC odometry -> windowed BA -> loop
closure and pose-graph optimization, `sfm/slam.IncrementalSlam`) with loop
closure off and on, and prints ATE RMSE (Umeyama-aligned), ATE as a share
of the trajectory's extent, keyframes, loop closures, mean inliers, the
last window BA's RMSE, and the median and mean wall time per frame by
stage, beside the device's name (and, on the card, its power limit):

    python -m accelerated_features_tpu_torch.apps.eval_slam \\
        --textures artifacts/rendered_pose_holdout/MegaDepth_v1 \\
        --weights artifacts/run_md_ckpt13250.npz --frames 32 --seed 3 \\
        [--res 640x480] [--json out.json] [--device cpu]

The device defaults to the GPU and the run raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import DEFAULT_WEIGHTS, XFeat, resolve_device
from ..sfm import IncrementalSlam, SlamConfig, absolute_trajectory_error
from ..sfm.lie import so3_exp, so3_log
from ..sfm.slam import STAGES, xfeat_frontend
from ..train.render import render_trajectory
from ..utils.imageio import load_textures


def gt_pose6(T_w2c: np.ndarray) -> np.ndarray:
    """(4,4) world-to-camera -> pose6 (rotvec, t) for the ATE helper."""
    w = so3_log(torch.as_tensor(T_w2c[:3, :3], dtype=torch.float32)).numpy()
    return np.concatenate([w, T_w2c[:3, 3]]).astype(np.float32)


def device_label(device: torch.device) -> str:
    """The device's name, with the card's power limit as nvidia-smi gives
    it."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def run_slam(frames, K, enable_loop_closure: bool, xfeat: XFeat,
             window: int = 6):
    """Track `frames` with `xfeat`'s front end on its device. Returns the
    tracker, the mean inliers of the tracked frames and the per-frame wall
    times by stage."""
    extract, match = xfeat_frontend(xfeat)
    slam = IncrementalSlam(
        K, SlamConfig(window=window, enable_loop_closure=enable_loop_closure),
        extract=extract, match=match, device=xfeat.device)
    inliers: List[int] = []
    ms: List[Dict[str, float]] = []
    for fr in frames:
        out = slam.process_frame(fr)
        inliers.append(out["n_inliers"])
        ms.append(out["ms"])
    mean_inl = float(np.mean(inliers[1:])) if len(inliers) > 1 else 0.0
    return slam, mean_inl, ms


def summarize(slam: IncrementalSlam, gt6: np.ndarray, mean_inl: float,
              ms: List[Dict[str, float]]) -> Dict[str, object]:
    """ATE (absolute and as a share of the ground truth's extent), counts,
    the last window BA's RMSE and the median and mean wall per frame by
    stage."""
    fids = slam.keyframe_frame_ids()
    est = slam.trajectory()
    ate = absolute_trajectory_error(est, gt6[fids])
    g = torch.as_tensor(gt6[fids])
    R = so3_exp(g[:, :3]).numpy()
    centers = np.stack([-R[i].T @ gt6[f, 3:] for i, f in enumerate(fids)])
    extent = float(np.linalg.norm(np.ptp(centers, axis=0)))
    return {
        "ate_rmse": float(ate),
        "ate_pct_of_extent": 100.0 * float(ate) / max(extent, 1e-9),
        "n_keyframes": int(len(est)),
        "n_loop_closures": int(slam.n_loop_closures),
        "n_relocalizations": int(slam.n_relocalizations),
        "mean_inliers": mean_inl,
        "last_window_ba_rmse_px": (float(slam.last_ba_rmse)
                                   if slam.last_ba_rmse is not None
                                   else None),
        "median_ms_per_frame": {k: float(np.median([m[k] for m in ms]))
                                for k in (*STAGES, "total")},
        "mean_ms_per_frame": {k: float(np.mean([m[k] for m in ms]))
                              for k in (*STAGES, "total")},
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, object]]:
    ap = argparse.ArgumentParser(description="SLAM/ATE benchmark on a "
                                             "rendered trajectory")
    ap.add_argument("--textures", type=str, required=True,
                    help="directory searched recursively for PNG textures")
    ap.add_argument("--weights", type=str, default=DEFAULT_WEIGHTS)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--res", type=str, default="640x480")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top_k", type=int, default=2048)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--arc_deg", type=float, default=35.0)
    ap.add_argument("--quads", type=int, default=16)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    label = device_label(device)
    w, h = map(int, args.res.split("x"))
    rng = np.random.default_rng(args.seed)
    texs = load_textures(args.textures, 16, rng)
    print(f"[render] {args.frames} frames {w}x{h}, arc {args.arc_deg} deg",
          flush=True)
    traj = render_trajectory(rng, texs, args.frames, w, h,
                             n_quads=args.quads, arc_deg=args.arc_deg,
                             loop=True)
    gt6 = np.stack([gt_pose6(T) for T in traj["poses"]])
    xf = XFeat(args.weights, top_k=args.top_k, device=device)

    results = {}
    for lc in (False, True):
        tag = "loop_closure" if lc else "odometry"
        slam, mean_inl, ms = run_slam(traj["images"], traj["K"], lc, xf,
                                      args.window)
        res = summarize(slam, gt6, mean_inl, ms)
        res["device"] = label
        results[tag] = res
        print(f"[{tag}] ATE {res['ate_rmse']:.4f} "
              f"({res['ate_pct_of_extent']:.2f}% of extent), "
              f"{res['n_keyframes']} KFs, {res['n_loop_closures']} loop "
              f"closures, mean inliers {mean_inl:.0f}, BA rmse "
              f"{res['last_window_ba_rmse_px']}", flush=True)
        for stat in ("median", "mean"):
            print(f"[{tag}] {stat} ms per frame on {label}: "
                  + ", ".join(f"{k} {v:.3f}" for k, v
                              in res[f"{stat}_ms_per_frame"].items()),
                  flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"[out] {args.json}")
    return results


if __name__ == "__main__":
    main()
