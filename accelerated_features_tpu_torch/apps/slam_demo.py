"""Incremental SLAM demo (counterpart of the JAX package's
`apps/slam_demo.py`): stream the frames of a directory through the online
tracker (`sfm/slam.IncrementalSlam`: keyframing, sliding-window BA, loop
closure) with the port's XFeat front end, and report the trajectory.

    python -m accelerated_features_tpu_torch.apps.slam_demo --images DIR \\
        [--fx 600] [--weights W] [--gt_poses gt.npy] [--device cpu]

Frames are the PNG and JPEG files of `DIR` in name order (any other file
is skipped, by its signature). Writes `slam_trajectory.npy` (keyframe
poses) to the working directory; with `--gt_poses` ((N, 6)
world-to-camera `.npy`, one row a frame) prints the ATE against the
poses of the keyframes' own frames. The device defaults to the GPU and
the run raises without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from ..api import DEFAULT_WEIGHTS, XFeat, resolve_device
from ..sfm import IncrementalSlam, SlamConfig, absolute_trajectory_error
from ..sfm.slam import xfeat_frontend
from ..utils.imageio import read_frames


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--top_k", type=int, default=2048)
    ap.add_argument("--weights", type=str, default=DEFAULT_WEIGHTS,
                    help="extractor weights (default: the trained "
                         "extractor); 'random' for a random one")
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--gt_poses", type=str, default=None)
    ap.add_argument("--max_frames", type=int, default=200)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    frames = read_frames(args.images, args.max_frames)
    if not frames:
        raise SystemExit(f"no readable images in {args.images}")
    # the first readable image defines the resolution
    h, w = frames[0][1].shape[:2]
    fx = args.fx or 1.2 * max(h, w)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])

    weights = None if args.weights == "random" else args.weights
    xf = XFeat(weights, top_k=args.top_k,
               detection_threshold=0.012 if weights is None else 0.05,
               device=device)
    extract, match = xfeat_frontend(xf)
    slam = IncrementalSlam(K, SlamConfig(window=args.window),
                           extract=extract, match=match, device=device)

    for i, frame in frames:
        out = slam.process_frame(frame)
        tag = "KF" if out["is_keyframe"] else "  "
        print(f"[slam] frame {i:4d} {tag} inliers {out['n_inliers']:4d} "
              f"pose t=({out['pose6'][3]:+.2f},{out['pose6'][4]:+.2f},"
              f"{out['pose6'][5]:+.2f})"
              + (f" ba_rmse {slam.last_ba_rmse:.2f}px"
                 if out["is_keyframe"] and slam.last_ba_rmse else ""),
              flush=True)

    traj = slam.trajectory()
    np.save("slam_trajectory.npy", traj)
    print(f"[slam] {len(traj)} keyframes -> slam_trajectory.npy")
    result = {"trajectory": traj, "keyframe_frame_ids":
              np.asarray(slam.keyframe_frame_ids()),
              "n_loop_closures": int(slam.n_loop_closures), "ate": None}
    if args.gt_poses:
        gt = np.load(args.gt_poses)
        # keyframes are a subset of the frames: compare against the pose of
        # each keyframe's own frame, not the first len(traj) frames
        result["ate"] = absolute_trajectory_error(
            traj, gt[slam.keyframe_frame_ids()])
        print(f"[slam] ATE: {result['ate']:.4f}")
    return result


if __name__ == "__main__":
    main()
