"""The JAX package's SLAM benchmark on the frames the port's renders: the
reference the port's `apps/eval_slam.py` is read against.

    python tests/slam_reference.py \\
        --textures artifacts/rendered_pose_holdout/MegaDepth_v1 \\
        --weights artifacts/run_md_ckpt13250.npz --frames 32 --seed 3 \\
        [--res 640x480] [--json out.json]

Textures come from the port's `utils/imageio.load_textures` (PNGs searched
recursively, so the holdout's nested layout serves as the pool); the
trajectory from the JAX package's `train/render.render_trajectory`, which
gives the port's frames (`tests/test_torch_sfm.py` holds the two renderers
equal); then the JAX package's `apps/eval_slam.run_slam` (its XFeat and
`IncrementalSlam`) runs on the CPU with loop closure off and on, and the
script prints what the port's app prints: ATE, ATE as a share of the
extent, keyframes, loop closures, mean inliers and the last BA's RMSE.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--textures", required=True)
    ap.add_argument("--weights", default=os.path.join(
        ROOT, "artifacts", "run_md_ckpt13250.npz"))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--res", default="640x480")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--top_k", type=int, default=2048)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from accelerated_features_tpu.sfm import absolute_trajectory_error
    from accelerated_features_tpu.sfm.lie import so3_exp
    from accelerated_features_tpu.train.render import render_trajectory
    from accelerated_features_tpu_torch.utils.imageio import load_textures
    from apps.eval_slam import gt_pose6, run_slam

    w, h = map(int, args.res.split("x"))
    rng = np.random.default_rng(args.seed)
    texs = load_textures(args.textures, 16, rng)
    traj = render_trajectory(rng, texs, args.frames, w, h, n_quads=16,
                             arc_deg=35.0, loop=True)
    gt6 = np.stack([gt_pose6(T) for T in traj["poses"]])
    results = {}
    for lc in (False, True):
        tag = "loop_closure" if lc else "odometry"
        slam, mean_inl = run_slam(traj["images"], traj["K"], lc,
                                  args.weights, args.top_k, 6)
        fids = slam.keyframe_frame_ids()
        est = slam.trajectory()
        ate = absolute_trajectory_error(est, gt6[fids])
        centers = [-np.asarray(so3_exp(jnp.asarray(p[:3]))).T @ p[3:]
                   for p in gt6[fids]]
        extent = float(np.linalg.norm(np.ptp(np.asarray(centers), axis=0)))
        results[tag] = {
            "ate_rmse": float(ate),
            "ate_pct_of_extent": 100.0 * float(ate) / max(extent, 1e-9),
            "n_keyframes": int(len(est)),
            "n_loop_closures": int(slam.n_loop_closures),
            "n_relocalizations": int(slam.n_relocalizations),
            "mean_inliers": mean_inl,
            "last_window_ba_rmse_px": slam.last_ba_rmse,
            "device": "cpu (JAX package)",
        }
        print(f"[{tag}] {json.dumps(results[tag])}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()
