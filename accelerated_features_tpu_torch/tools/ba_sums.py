"""The window BA's segment sums on the card: the port's deterministic
table sums (`sfm/ba.segment_tables`) against `index_add_` (float atomics),
in turns within one process.

    python3 -m accelerated_features_tpu_torch.tools.ba_sums [--frames 10]

Renders the first `--frames` frames of the SLAM benchmark's trajectory
(640x480, seed 3, holdout textures), tracks them with the default front
end on the card, loop closure off, and takes the last window BA's problem.
It is solved as the tracker solves it (6 LM x 25 CG iterations) seven
times with each kind of sum, in the order tables, atomics, atomics,
tables; for each round it prints the median wall of a solve (host clock,
ended by a synchronize) and the spread of the seven solutions: the
largest camera difference over the largest camera value, and the largest
cost difference.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..sfm import IncrementalSlam, SlamConfig, ba
from ..train.render import render_trajectory
from ..utils.imageio import load_textures

ROOT = Path(__file__).resolve().parents[2]


def _atomic_tables(p):
    return ba.SegmentTables((p.obs_cam, p.cams.shape[0]),
                            (p.obs_pt, p.points.shape[0]))


def _atomic_sum(x, seg_n):
    seg, n = seg_n
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, seg, x)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    rng = np.random.default_rng(3)
    texs = load_textures(ROOT / "artifacts" / "rendered_pose_holdout"
                         / "MegaDepth_v1", 16, rng)
    traj = render_trajectory(rng, texs, args.frames, 640, 480, n_quads=16,
                             arc_deg=35.0, loop=True)
    slam = IncrementalSlam(traj["K"], SlamConfig(enable_loop_closure=False))
    for im in traj["images"]:
        slam.process_frame(im)
    p = slam.last_ba_problem
    print(f"window BA problem: {p.cams.shape[0]} cameras, "
          f"{p.points.shape[0]} padded points, {int(p.obs_mask.sum())} of "
          f"{p.obs_mask.numel()} observations, on "
          f"{torch.cuda.get_device_name(0)}")
    kinds = {"tables": (ba.segment_tables, ba._segment_sum),
             "index_add_": (_atomic_tables, _atomic_sum)}

    def solve():
        out, info = ba.bundle_adjust(p, iters=6, cg_iters=25)
        torch.cuda.synchronize()
        return out.cams, float(info["final_cost"])

    for kind in ("tables", "index_add_", "index_add_", "tables"):
        ba.segment_tables, ba._segment_sum = kinds[kind]
        solve()
        walls, outs = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            outs.append(solve())
            walls.append((time.perf_counter() - t0) * 1e3)
        c0, cost0 = outs[0]
        spread = max(float((c - c0).abs().max()) for c, _ in outs) \
            / float(c0.abs().max())
        cost_spread = max(abs(c - cost0) for _, c in outs)
        print(f"{kind}: median {sorted(walls)[3]:.2f} ms of {walls}; "
              f"spread: cameras {spread:.3g}, cost {cost_spread:.4g} of "
              f"{cost0:.6g}")
    ba.segment_tables, ba._segment_sum = kinds["tables"]


if __name__ == "__main__":
    main()
