"""Monocular SLAM on a rendered ground-truth trajectory, with ATE, on
the PyTorch port (port version of `09_slam_ate.py`).

Renders a short orbit with exact poses (`train/render.render_trajectory`,
noise textures from a seed), streams it through the incremental tracker
(XFeat extraction, MNN matching, two-view pose, windowed bundle
adjustment, loop closure and pose-graph optimization, `sfm/slam.py`)
with the trained extractor, and reports the Umeyama-aligned ATE RMSE
against the ground truth.

    python examples/torch_09_slam_ate.py [--frames 16] [--res 320x240] \\
        [--device cpu]

Runs on the GPU unless given `--device cpu`.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--res", default="320x240")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    from accelerated_features_tpu_torch import XFeat
    from accelerated_features_tpu_torch.apps.eval_slam import gt_pose6
    from accelerated_features_tpu_torch.sfm import (IncrementalSlam,
                                                    SlamConfig,
                                                    absolute_trajectory_error)
    from accelerated_features_tpu_torch.sfm.slam import xfeat_frontend
    from accelerated_features_tpu_torch.train.render import \
        render_trajectory

    w, h = map(int, args.res.split("x"))
    rng = np.random.default_rng(0)
    # corner-rich noise textures (a texture pool directory works too)
    texs = [rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
            for _ in range(12)]
    traj = render_trajectory(rng, texs, n_frames=args.frames, w=w, h=h,
                             arc_deg=30.0, loop=True)

    xf = XFeat(top_k=1024, device=args.device)
    extract, match = xfeat_frontend(xf)
    slam = IncrementalSlam(traj["K"], SlamConfig(window=5), extract=extract,
                           match=match, device=xf.device)
    for i, frame in enumerate(traj["images"]):
        out = slam.process_frame(frame)
        print(f"frame {i:3d} {'KF' if out['is_keyframe'] else '  '} "
              f"inliers {out['n_inliers']:4d}"
              f"{'  LOOP' if out['loop_closed'] else ''}")

    gt6 = np.stack([gt_pose6(T) for T in traj["poses"]])
    fids = slam.keyframe_frame_ids()
    ate = absolute_trajectory_error(slam.trajectory(), gt6[fids])
    print(f"\n{len(fids)} keyframes, {slam.n_loop_closures} loop "
          f"closures, ATE RMSE {ate:.4f} on {xf.device}")


if __name__ == "__main__":
    main()
