"""Multi-view track building from pairwise matches (counterpart of the JAX
package's `sfm/tracks.py`).

Union-find over (frame, keypoint) observations merges pairwise matches into
tracks; tracks spanning >= `min_length` views become landmarks with one
observation per view — turning the SfM pipeline's pair-local triangulations
into proper multi-view constraints for bundle adjustment.

Host-side (graph algorithm); the resulting observation table feeds the
fixed-shape device BA (sfm/ba.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .lie import se3_matrix


class UnionFind:
    def __init__(self):
        self.parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(self, x):
        root = x
        while self.parent.get(root, root) != root:
            root = self.parent[root]
        while self.parent.get(x, x) != x:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_tracks(pair_matches: Dict[Tuple[int, int],
                                    Tuple[np.ndarray, np.ndarray]],
                 keypoints: Sequence[np.ndarray],
                 min_length: int = 2,
                 return_kp: bool = False):
    """Merge pairwise matches into multi-view tracks.

    Args:
      pair_matches: {(frame_i, frame_j): (idx_i (S,), idx_j (S,))}.
      keypoints: per-frame (N_f, 2) keypoint arrays.
      min_length: minimum distinct views per track.
      return_kp: also return obs_kp (N,) — the keypoint index of each
        observation in its frame (lets SLAM map BA depths back onto
        keyframe keypoints for monocular scale bookkeeping).

    Returns:
      obs_cam (N,), obs_pt (N,), obs_uv (N, 2), n_tracks — observation table
      for BAProblem (plus obs_kp (N,) when return_kp). Tracks containing
      two observations in the SAME frame (merge conflicts) are dropped,
      standard SfM hygiene.
    """
    uf = UnionFind()
    for (fi, fj), (ii, jj) in pair_matches.items():
        for a, b in zip(np.asarray(ii).tolist(), np.asarray(jj).tolist()):
            uf.union((fi, int(a)), (fj, int(b)))

    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for (fi, fj), (ii, jj) in pair_matches.items():
        for node in [(fi, int(a)) for a in np.asarray(ii)] + \
                    [(fj, int(b)) for b in np.asarray(jj)]:
            groups.setdefault(uf.find(node), []).append(node)

    obs_cam, obs_pt, obs_uv, obs_kp = [], [], [], []
    n_tracks = 0
    for nodes in groups.values():
        nodes = sorted(set(nodes))
        frames = [f for f, _ in nodes]
        if len(set(frames)) < min_length:
            continue
        if len(frames) != len(set(frames)):
            continue  # conflict: two keypoints of one frame in one track
        for f, k in nodes:
            obs_cam.append(f)
            obs_pt.append(n_tracks)
            obs_uv.append(keypoints[f][k])
            obs_kp.append(k)
        n_tracks += 1

    if n_tracks == 0:
        out = (np.zeros(0, np.int32), np.zeros(0, np.int32),
               np.zeros((0, 2), np.float32), 0)
        return out + (np.zeros(0, np.int32),) if return_kp else out
    out = (np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32),
           np.asarray(obs_uv, np.float32), n_tracks)
    return out + (np.asarray(obs_kp, np.int32),) if return_kp else out


def triangulate_tracks(obs_cam: np.ndarray, obs_pt: np.ndarray,
                       obs_uv: np.ndarray, n_tracks: int,
                       poses6: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Multi-view DLT triangulation per track given camera poses (N,6)."""
    Ts = se3_matrix(torch.as_tensor(np.asarray(poses6, np.float32))).numpy()
    Ps = np.einsum("ij,njk->nik", K, Ts[:, :3])
    X = np.zeros((n_tracks, 3), np.float32)
    for t in range(n_tracks):
        sel = obs_pt == t
        rows = []
        for c, uv in zip(obs_cam[sel], obs_uv[sel]):
            P = Ps[c]
            rows.append(uv[0] * P[2] - P[0])
            rows.append(uv[1] * P[2] - P[1])
        A = np.stack(rows)
        _, _, vt = np.linalg.svd(A)
        h = vt[-1]
        X[t] = h[:3] / (h[3] if abs(h[3]) > 1e-12 else 1e-12)
    return X
