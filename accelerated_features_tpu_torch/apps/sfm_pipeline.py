"""Incremental SfM over an image sequence, the north-star demo
(counterpart of the JAX package's `apps/sfm_pipeline.py`): XFeat
extraction -> MNN matching -> two-view posekit RANSAC -> keyframe pose
graph -> multi-view tracks -> global bundle adjustment.

    python -m accelerated_features_tpu_torch.apps.sfm_pipeline \\
        --images DIR [--fx 600] [--weights W] [--gt_poses gt.npy] \\
        [--device cpu]

Frames are the PNG and JPEG files of `DIR` in name order (any other file
is skipped, by its signature). Writes `sfm_poses.npy` and
`sfm_points.npy` to the working directory; with `--gt_poses` ((N, 6)
world-to-camera `.npy`) prints the ATE. Under `torchrun` with
`--sharded`, the bundle adjustment runs split over the ranks
(`parallel/ba.bundle_adjust_sharded`; every rank builds the same
problem, rank 0 prints and writes); otherwise it runs on one device.
The device defaults to the GPU and the run raises without one.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import DEFAULT_WEIGHTS, XFeat, resolve_device
from ..geometry.pose import estimate_relative_pose
from ..parallel import distributed
from ..parallel.mesh import make_mesh, world
from ..sfm import (BAProblem, PoseGraph, absolute_trajectory_error,
                   build_tracks, bundle_adjust, optimize_pose_graph,
                   reprojection_rmse, se3_compose, se3_from_Rt, se3_matrix,
                   triangulate_tracks)
from ..utils.imageio import read_frames


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", required=True, help="directory of frames")
    ap.add_argument("--fx", type=float, default=None,
                    help="focal (px); default 1.2*max(W,H)")
    ap.add_argument("--top_k", type=int, default=2048)
    ap.add_argument("--weights", type=str, default=DEFAULT_WEIGHTS,
                    help="extractor weights (default: the trained "
                         "extractor); 'random' for a random one")
    ap.add_argument("--ba_iters", type=int, default=15)
    ap.add_argument("--sharded", action="store_true",
                    help="under torchrun: BA split over the ranks")
    ap.add_argument("--gt_poses", type=str, default=None)
    ap.add_argument("--max_frames", type=int, default=50)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    distributed.initialize(device=device.type)
    primary = world()[0] == 0

    def log(msg):
        if primary:
            print(msg, flush=True)

    frames = [f for _, f in read_frames(args.images, args.max_frames)]
    if len(frames) < 2:
        raise SystemExit("need at least two readable frames")
    h, w = frames[0].shape[:2]
    fx = args.fx or 1.2 * max(h, w)
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    log(f"[sfm] {len(frames)} frames {w}x{h}, fx={fx:.0f}")

    weights = None if args.weights == "random" else args.weights
    xf = XFeat(weights, top_k=args.top_k,
               detection_threshold=0.012 if weights is None else 0.05,
               device=device)
    feats = [{k: v.cpu().numpy() for k, v in xf.detectAndCompute(f)[0]
              .items()} for f in frames]
    log(f"[sfm] extracted ({np.mean([len(f['keypoints']) for f in feats]):.0f}"
        f" kpts/frame)")

    # sequential two-view geometry -> pose graph; the pairs' inlier
    # matches also feed the multi-view tracks
    graph = PoseGraph.empty()
    graph.add_keyframe(np.zeros(6, np.float32))
    pair_matches = {}
    for i in range(len(frames) - 1):
        i0, i1 = (t.cpu().numpy() for t in xf.match(
            feats[i]["descriptors"], feats[i + 1]["descriptors"],
            min_cossim=-1))
        p0 = feats[i]["keypoints"][i0]
        p1 = feats[i + 1]["keypoints"][i1]
        res = estimate_relative_pose(p0, p1, K, K, max_epipolar_error=2.0)
        if res is None:
            log(f"[sfm] pair {i}-{i+1}: pose failed; identity edge")
            rel = np.zeros(6, np.float32)
            inl = np.zeros(len(p0), bool)
        else:
            R, t, inl = res
            rel = se3_from_Rt(torch.as_tensor(R, dtype=torch.float32),
                              torch.as_tensor(t, dtype=torch.float32)).numpy()
        prev = torch.as_tensor(graph.poses[i])
        graph.add_keyframe(se3_compose(torch.as_tensor(rel), prev).numpy())
        graph.add_edge(i, i + 1, rel, weight=float(max(inl.sum(), 1)))
        pair_matches[(i, i + 1)] = (i0[inl], i1[inl])
        log(f"[sfm] pair {i}-{i+1}: {len(p0)} matches, {inl.sum()} inliers")

    poses, info = optimize_pose_graph(graph, iters=20, device=device)
    log(f"[sfm] pose graph: cost {info['initial_cost']:.3f} -> "
        f"{info['final_cost']:.3f}")

    # multi-view tracks from the pairs' inlier matches -> triangulation
    obs_cam, obs_pt, obs_uv, n_tracks = build_tracks(
        pair_matches, [f["keypoints"] for f in feats], min_length=2)
    log(f"[sfm] {n_tracks} tracks "
        f"(mean length {len(obs_cam)/max(n_tracks,1):.1f})")
    X = triangulate_tracks(obs_cam, obs_pt, obs_uv, n_tracks,
                           np.asarray(poses, np.float32),
                           np.asarray(K, np.float32))
    # drop a track that any observing camera sees at non-positive depth,
    # or that lies absurdly far
    Ts = se3_matrix(torch.as_tensor(np.asarray(poses, np.float32))).numpy()
    z = np.einsum("nij,mj->nmi", Ts[:, :3, :3], X)[:, :, 2] + Ts[:, None, 2, 3]
    bad_obs = z[obs_cam, obs_pt] <= 1e-2
    ok = ((np.bincount(obs_pt, weights=bad_obs, minlength=n_tracks) == 0)
          & (np.linalg.norm(X, axis=1) < 1e4))
    keep_obs = ok[obs_pt]
    remap = np.cumsum(ok) - 1
    obs_cam = obs_cam[keep_obs]
    obs_pt = remap[obs_pt[keep_obs]]
    obs_uv = obs_uv[keep_obs]
    X = X[ok].astype(np.float32)
    log(f"[sfm] map: {len(X)} points, {len(obs_cam)} observations")

    fixed = np.zeros(len(poses), bool)
    fixed[0] = True

    def on_dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    problem = BAProblem(
        cams=on_dev(poses, torch.float32), points=on_dev(X, torch.float32),
        K=on_dev(K, torch.float32), obs_cam=on_dev(obs_cam, torch.int64),
        obs_pt=on_dev(obs_pt, torch.int64),
        obs_uv=on_dev(obs_uv, torch.float32),
        obs_mask=torch.ones((len(obs_cam),), dtype=torch.bool,
                            device=device),
        fixed_cams=on_dev(fixed, torch.bool))

    rmse0 = float(reprojection_rmse(problem))
    n_ranks = world()[1]
    if args.sharded and n_ranks > 1:
        from ..parallel.ba import bundle_adjust_sharded
        solved, binfo = bundle_adjust_sharded(
            problem, make_mesh((n_ranks, 1)), iters=args.ba_iters)
        log(f"[sfm] BA sharded over {n_ranks} ranks")
    else:
        solved, binfo = bundle_adjust(problem, iters=args.ba_iters)
    rmse1 = float(reprojection_rmse(solved))
    log(f"[sfm] BA: reprojection RMSE {rmse0:.2f} -> {rmse1:.2f} px "
        f"(cost {float(binfo['initial_cost']):.1f} -> "
        f"{float(binfo['final_cost']):.1f})")

    out_poses = solved.cams.cpu().numpy()
    out_points = solved.points.cpu().numpy()
    if primary:
        np.save("sfm_poses.npy", out_poses)
        np.save("sfm_points.npy", out_points)
    log("[sfm] wrote sfm_poses.npy / sfm_points.npy")

    result = {"poses": out_poses, "points": out_points,
              "rmse_before": rmse0, "rmse_after": rmse1,
              "initial_cost": float(binfo["initial_cost"]),
              "final_cost": float(binfo["final_cost"]), "ate": None}
    if args.gt_poses:
        gt = np.load(args.gt_poses)
        result["ate"] = absolute_trajectory_error(out_poses,
                                                  gt[:len(out_poses)])
        log(f"[sfm] ATE vs GT: {result['ate']:.4f}")
    return result


if __name__ == "__main__":
    main()
