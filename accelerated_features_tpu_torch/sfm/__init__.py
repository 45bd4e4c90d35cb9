"""SfM/SLAM layer of the port (counterpart of the JAX package's `sfm/`):
SO(3)/SE(3) utilities, bundle adjustment, the pose graph, multi-view
tracks, two-view bootstrapping and the incremental SLAM tracker."""

from .ba import (BAProblem, ba_cost, ba_step, bundle_adjust, project,
                 reprojection_rmse)
from .lie import (se3_apply, se3_compose, se3_from_Rt, se3_inverse,
                  se3_matrix, so3_exp, so3_log)
from .posegraph import (PoseGraph, absolute_trajectory_error,
                        optimize_pose_graph)
from .slam import IncrementalSlam, SlamConfig
from .tracks import build_tracks, triangulate_tracks
from .twoview import triangulate_linear, two_view_reconstruction

__all__ = [
    "BAProblem", "bundle_adjust", "ba_step", "ba_cost", "project",
    "reprojection_rmse", "so3_exp", "so3_log", "se3_apply", "se3_compose",
    "se3_from_Rt", "se3_inverse", "se3_matrix", "PoseGraph",
    "optimize_pose_graph", "absolute_trajectory_error",
    "triangulate_linear", "two_view_reconstruction",
    "build_tracks", "triangulate_tracks", "IncrementalSlam", "SlamConfig",
]
