"""Incremental SLAM front end: online keyframe selection, pose tracking,
sliding-window bundle adjustment, loop closure, and relocalization
(counterpart of the JAX package's `sfm/slam.py`).

Frames stream in, each is matched against the last keyframe; relative
pose comes from the native LO-RANSAC; keyframes are inserted on viewpoint
change or match decay; a windowed BA over the last W keyframes refines
poses and the local map after every insertion.

Loop closure: every new keyframe is scored against past keyframes by a
pooled global descriptor (mean of L2-normalized local descriptors); the
top candidates beyond a temporal gap are MNN-matched and geometrically
verified with the same LO-RANSAC. A verified loop adds an edge to the pose
graph and triggers full pose-graph optimization, distributing accumulated
drift around the loop.

Relocalization: when tracking is lost (too few matches/inliers against the
last keyframe), the same retrieval + verification machinery searches ALL
keyframes and re-anchors the track on the best match.

The extractor/matcher are injectable callables so the tracker is testable
with synthetic geometry and usable with any feature front end (default:
the port's XFeat, sparse extraction + MNN, on the tracker's device). The
tracker's bookkeeping is numpy: the default front end hands its tensors
over as numpy once per call (`xfeat_frontend`). Lie-group bookkeeping runs
on the CPU in float32; the window BA and the pose graph run on the
tracker's device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..geometry.pose import (decompose_homography, estimate_homography,
                             estimate_relative_pose)
from .ba import BAProblem, bundle_adjust, reprojection_rmse
from .lie import (se3_compose, se3_from_Rt, se3_inverse, se3_matrix,
                  so3_exp, so3_log)
from .posegraph import PoseGraph, optimize_pose_graph
from .tracks import build_tracks, triangulate_tracks

# stages of `process_frame`'s wall time, in milliseconds
STAGES = ("extract", "match", "pose", "window_ba", "pose_graph")


def _f32(x) -> torch.Tensor:
    """Host bookkeeping: numpy -> float32 CPU tensor."""
    return torch.as_tensor(np.asarray(x, np.float32))


def xfeat_frontend(xfeat) -> Tuple[Callable, Callable]:
    """(extract, match) of the tracker for a port `XFeat`: sparse
    extraction, and MNN matching at min_cossim=-1; each hands its result
    over as numpy, once per call."""
    def extract(image):
        out = xfeat.detectAndCompute(image)[0]
        return {k: v.cpu().numpy() for k, v in out.items()}

    def match(d0, d1):
        i0, i1 = xfeat.match(d0["descriptors"], d1["descriptors"],
                             min_cossim=-1)
        return i0.cpu().numpy(), i1.cpu().numpy()
    return extract, match


@dataclasses.dataclass
class SlamConfig:
    window: int = 6                 # keyframes in the BA window
    kf_min_inliers: int = 60        # insert KF when inliers drop below
    kf_max_inlier_ratio: float = 0.6  # ... or inlier ratio decays below
    min_matches: int = 20           # below this the frame is untrackable
    ba_iters: int = 6
    cg_iters: int = 25
    ransac_px: float = 2.0
    min_track_length: int = 2
    # windowed-BA input gating: observations whose triangulated point
    # sits closer than `ba_min_depth` to (or behind) any observing
    # camera, or reprojects worse than `ba_max_reproj_px`, are dropped
    # before the solve — mismatched tracks chained across frames
    # otherwise seed BA with ~1e8-px residuals it cannot recover from
    ba_min_depth: float = 0.05
    ba_max_reproj_px: float = 20.0
    # loop closure / relocalization
    enable_loop_closure: bool = True
    loop_min_gap: int = 4           # skip this many most-recent keyframes
    loop_candidates: int = 3        # geometric checks per new keyframe
    loop_min_sim: float = 0.6       # global-descriptor cosine gate
    # 30 inliers verified loop edges with 45-60 deg rotation error on the
    # rendered benchmark (wide-baseline pairs with few, plane-concentrated
    # matches); 80 keeps only edges whose pose quality matches odometry's
    loop_min_inliers: int = 80      # RANSAC inliers to accept a loop
    loop_min_scale_votes: int = 5   # stored-depth votes to trust edge scale
    # a loop edge must roughly AGREE with the current pose estimates,
    # with an allowance that GROWS with the temporal gap (drift
    # accumulates per keyframe, and long-range loops are exactly the
    # ones that must be allowed to contradict a drifted estimate):
    # allowed = base + per_gap * (j - i). Repeated textures produce
    # geometrically consistent FALSE matches on SHORT-range pairs
    # (measured: 45-60 deg rotation error at 85+ inliers, gaps <= 7) —
    # those stay gated; a gap-40 true loop gets ~75 deg of slack.
    loop_max_rot_residual_deg: float = 15.0
    loop_rot_residual_per_gap_deg: float = 1.5
    reloc_min_inliers: int = 25     # RANSAC inliers to accept a reloc


@dataclasses.dataclass
class Keyframe:
    index: int                       # keyframe id
    features: Dict[str, np.ndarray]  # 'keypoints' (N,2), 'descriptors'
    pose6: np.ndarray                # world->cam
    global_desc: np.ndarray          # pooled retrieval descriptor
    frame_id: int = -1               # source frame number (for GT lookup)


def _two_view_depths(k0: np.ndarray, k1: np.ndarray, K: np.ndarray,
                     R: np.ndarray, t: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized two-view DLT triangulation of correspondences for
    cameras P0 = K[I|0], P1 = K[R|t]; returns per-point z-depths in each
    camera frame (host-side numpy — this is tracker bookkeeping, not the
    device compute path)."""
    P0 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K @ np.hstack([R, t.reshape(3, 1)])
    A = np.empty((len(k0), 4, 4), np.float64)
    A[:, 0] = k0[:, 0, None] * P0[2] - P0[0]
    A[:, 1] = k0[:, 1, None] * P0[2] - P0[1]
    A[:, 2] = k1[:, 0, None] * P1[2] - P1[0]
    A[:, 3] = k1[:, 1, None] * P1[2] - P1[1]
    _, _, vt = np.linalg.svd(A)
    h = vt[:, -1, :]
    w = np.where(np.abs(h[:, 3]) > 1e-12, h[:, 3], 1e-12)
    X = h[:, :3] / w[:, None]
    d1 = X @ R[2] + t[2]
    return X[:, 2], d1


def _global_desc(feats: Dict[str, np.ndarray]) -> np.ndarray:
    """Pooled retrieval descriptor; zero vector when the front end provides
    no descriptors (retrieval then never fires — plain odometry)."""
    d = np.asarray(feats.get("descriptors",
                             np.zeros((0, 1), np.float32)), np.float32)
    if d.size == 0:
        return np.zeros((1,), np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    g = d.mean(0)
    return g / max(np.linalg.norm(g), 1e-12)


class IncrementalSlam:
    """Streaming tracker. `extract(image) -> {'keypoints','descriptors'}`
    and `match(d0, d1) -> (idx0, idx1)` (numpy) are injectable; by default
    they are `xfeat_frontend(XFeat(top_k=2048))` on `device`. `device`: where
    the window BA, the pose graph and the default front end run (None: the
    GPU, and it raises without one)."""

    def __init__(self, K: np.ndarray, config: Optional[SlamConfig] = None,
                 extract: Optional[Callable] = None,
                 match: Optional[Callable] = None,
                 device: Optional[Union[str, torch.device]] = None):
        from ..api import resolve_device
        self.device = resolve_device(device)
        self.K = np.asarray(K, np.float64)
        # fresh default per instance: SlamConfig is mutable, so a shared
        # default instance would leak config edits across trackers
        self.cfg = config if config is not None else SlamConfig()
        self._extract = extract
        self._match = match
        self._frontend: Optional[Tuple[Callable, Callable]] = None

        self.graph = PoseGraph.empty()
        self.keyframes: List[Keyframe] = []
        self.pair_matches: Dict[Tuple[int, int],
                                Tuple[np.ndarray, np.ndarray]] = {}
        self.current_pose = np.zeros(6, np.float32)
        self.n_frames = 0
        self.n_loop_closures = 0
        self.n_relocalizations = 0
        self.last_ba_rmse: Optional[float] = None
        # the input of the last window BA, on the device
        self.last_ba_problem: Optional[BAProblem] = None
        self._ms: Dict[str, float] = {}
        # monocular scale propagation: per-keyframe {keypoint idx ->
        # triangulated z-depth in that keyframe's camera frame}, written
        # when the keyframe is inserted and consumed to rescale the
        # unit-norm essential-matrix translation of every later edge
        # anchored on it (without this, each edge carries its own
        # arbitrary scale and windowed BA fights inconsistent geometry)
        self._kf_depths: Dict[int, Dict[int, float]] = {}
        self._pending_depths: Dict[int, float] = {}

    # ------------------------------------------------------------ defaults

    def _default_frontend(self) -> Tuple[Callable, Callable]:
        if self._frontend is None:
            from ..api import XFeat
            self._frontend = xfeat_frontend(XFeat(top_k=2048,
                                                  device=self.device))
        return self._frontend

    @contextlib.contextmanager
    def _timed(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._ms[stage] += (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------ pipeline

    def process_frame(self, image) -> Dict[str, np.ndarray]:
        """Track one frame. Returns {'pose6', 'is_keyframe', 'n_inliers',
        'loop_closed', 'relocalized', 'ms'}: 'ms' is the frame's wall time
        in milliseconds by stage (`STAGES`, each stage's device work
        included: every stage ends by reading its results on the host) and
        in all ('total')."""
        t0 = time.perf_counter()
        self._ms = dict.fromkeys(STAGES, 0.0)
        out = self._process(image)
        self._ms["total"] = (time.perf_counter() - t0) * 1e3
        out["ms"] = self._ms
        return out

    def _process(self, image) -> Dict[str, np.ndarray]:
        extract = self._extract or self._default_frontend()[0]
        match = self._match or self._default_frontend()[1]
        with self._timed("extract"):
            feats = extract(image)
        self.n_frames += 1
        loop_closed = False
        relocalized = False

        if not self.keyframes:
            self._insert_keyframe(feats, np.zeros(6, np.float32))
            return {"pose6": self.current_pose.copy(), "is_keyframe": True,
                    "n_inliers": 0, "loop_closed": False,
                    "relocalized": False}

        kf = self.keyframes[-1]
        with self._timed("match"):
            i0, i1 = match(kf.features, feats)
        n_matches = len(i0)
        rel = np.zeros(6, np.float32)
        n_inl = 0
        inlier_mask = np.zeros(n_matches, bool)
        if n_matches >= self.cfg.min_matches:
            with self._timed("pose"):
                res = self._estimate_edge(
                    np.asarray(kf.features["keypoints"])[i0],
                    np.asarray(feats["keypoints"])[i1])
                if res is not None:
                    R, t, inlier_mask = res
                    n_inl = int(inlier_mask.sum())
                    s, self._pending_depths, _ = self._edge_scale(
                        kf, i0, i1, feats, R, t, inlier_mask)
                    rel = se3_from_Rt(_f32(R), _f32(s * t)).numpy()

        if n_inl < 8:
            # tracking lost -> relocalize against the whole keyframe set
            anchor = self._relocalize(feats, match)
            if anchor is not None:
                kf, i0, i1, rel, inlier_mask, n_inl = anchor
                relocalized = True
                self.n_relocalizations += 1

        self.current_pose = se3_compose(_f32(rel), _f32(kf.pose6)).numpy()

        is_kf = relocalized or (
            n_inl < self.cfg.kf_min_inliers or
            n_inl < self.cfg.kf_max_inlier_ratio * max(n_matches, 1))
        if is_kf and n_inl >= 8:
            prev = kf.index
            new_idx = self._insert_keyframe(feats, self.current_pose)
            self._kf_depths[new_idx] = self._pending_depths
            mask_idx = np.nonzero(inlier_mask)[0]
            self.pair_matches[(prev, new_idx)] = (i0[mask_idx], i1[mask_idx])
            self.graph.add_edge(prev, new_idx, rel,
                                weight=float(max(n_inl, 1)))
            # window BA FIRST: it refreshes the new keyframe's depth map
            # from the BA-consistent local geometry, which the loop
            # verifier needs to resolve the loop edge's monocular scale
            # (loop pairs rarely share enough points with the distant
            # anchor's bookkept subset alone)
            with self._timed("window_ba"):
                self._window_ba()
            if self.cfg.enable_loop_closure:
                loop_closed = self._try_loop_closure(new_idx, match)
        return {"pose6": self.current_pose.copy(), "is_keyframe": bool(is_kf),
                "n_inliers": n_inl, "loop_closed": loop_closed,
                "relocalized": relocalized}

    # ------------------------------------------------------- loop closure

    def _retrieve(self, gdesc: np.ndarray, exclude_after: int,
                  k: int) -> List[int]:
        """Top-k past keyframes by pooled-descriptor cosine similarity."""
        sims = [(float(np.dot(kf.global_desc, gdesc)), kf.index)
                for kf in self.keyframes if kf.index < exclude_after]
        sims.sort(reverse=True)
        return [idx for s, idx in sims[:k] if s >= self.cfg.loop_min_sim]

    def _estimate_edge(self, p0: np.ndarray, p1: np.ndarray):
        """Two-view pose with E/H MODEL SELECTION — the planar-degeneracy
        defence every serious monocular tracker needs (ORB-SLAM-style).

        A dominant scene plane makes the essential matrix ambiguous (a
        2-parameter family of E fits coplanar points), so 5-pt LO-RANSAC
        can return a confidently wrong pose (measured on the rendered
        SLAM benchmark: near-identity rotations with hundreds of
        inliers). Fit BOTH models, decompose the homography
        (geometry.decompose_homography), and score every candidate pose
        by cheirality + epipolar support over ALL matches; return the
        winner as (R, t, mask). Returns None when nothing verifies."""
        cfg = self.cfg
        cands = []          # (R, t, mask_for_bookkeeping)
        res_e = estimate_relative_pose(
            p0, p1, self.K, self.K, max_epipolar_error=cfg.ransac_px)
        if res_e is not None:
            cands.append(res_e)
        res_h = estimate_homography(p0, p1, thresh=max(cfg.ransac_px, 2.0))
        if res_h is not None and int(res_h[1].sum()) >= 12:
            H, hmask = res_h
            hidx = np.nonzero(hmask)[0]
            for (R, t, _n) in decompose_homography(
                    H, self.K, self.K, p0[hidx], p1[hidx]):
                cands.append((R, t, hmask))
        if not cands:
            return None

        # score: matches that are in FRONT of both cameras and on the
        # epipolar model (pixel sampson err below the RANSAC threshold)
        Kinv = np.linalg.inv(self.K)
        x0 = np.concatenate([p0, np.ones((len(p0), 1))], 1) @ Kinv.T
        x1 = np.concatenate([p1, np.ones((len(p1), 1))], 1) @ Kinv.T
        favg = 0.5 * (self.K[0, 0] + self.K[1, 1])
        thr = cfg.ransac_px / favg

        def support(R, t):
            """(count, mask) of matches in FRONT of both cameras and on
            the epipolar model implied by (R, t)."""
            tn = np.linalg.norm(t)
            if tn < 1e-9:
                # pure rotation: rotation-transfer error replaces epipolar
                xr = x0 @ R.T
                xr = xr / np.maximum(np.abs(xr[:, 2:]), 1e-12)
                err = np.linalg.norm((xr - x1)[:, :2], axis=1)
                m = err < thr
                return int(m.sum()), m
            E = np.array([[0, -t[2], t[1]],
                          [t[2], 0, -t[0]],
                          [-t[1], t[0], 0]]) @ R
            Ex0 = x0 @ E.T
            Etx1 = x1 @ E
            num = np.sum(x1 * Ex0, axis=1) ** 2
            den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 \
                + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
            samp = num / np.maximum(den, 1e-18)
            on_model = samp < thr ** 2
            d0, d1 = _two_view_depths(p0, p1, self.K, R, t)
            m = on_model & (d0 > 1e-9) & (d1 > 1e-9)
            return int(m.sum()), m

        # candidate 0 is the E-pose: prefer it on score ties (easy
        # small-motion edges saturate every candidate's support, and an
        # H decomposition winning a tie would hand back its plane-subset
        # mask, starving downstream scale bookkeeping)
        best_k, best_n, best_mask = 0, -1, None
        for k, (R, t, _m) in enumerate(cands):
            n, m = support(R, t)
            if n > best_n:
                best_k, best_n, best_mask = k, n, m
        R, t, _ = cands[best_k]
        # the winner's support over ALL matches is the richest consistent
        # inlier set — use it as the returned mask (the per-model RANSAC
        # mask can be a small subset, e.g. only the points on H's plane)
        return R, t, np.asarray(best_mask, bool)

    def _edge_scale(self, kf_anchor: Keyframe, i0, i1, feats,
                    R: np.ndarray, t: np.ndarray, mask: np.ndarray,
                    feats_kf_index: Optional[int] = None
                    ) -> Tuple[float, Dict[int, float], int]:
        """Monocular scale for one edge: triangulate the inliers under
        the unit-norm (R, t), then pick s = median(stored_depth /
        unit_depth) over keypoints of the anchor keyframe whose depths
        are known. The first edge (no stored depths) defines the global
        scale with s = 1 — ATE alignment is similarity-based so the free
        gauge is harmless. The anchor's depth map is ENRICHED in place
        with the newly triangulated depths (missing keys only): the
        bootstrap keyframe starts with no map at all, and without
        enrichment every later loop edge anchored on it would fall back
        to unit scale and corrupt the pose graph (measured: a 6x scale
        flip after one relocalization). Returns (s, the new frame's
        scaled depth map keyed by its keypoint indices, n_shared = how
        many stored depths voted — 0 means the scale is a GUESS)."""
        idx = np.nonzero(np.asarray(mask, bool))[0]
        if idx.size == 0 or np.linalg.norm(t) < 1e-9:
            # no inliers, or a pure-rotation edge (zero baseline
            # triangulates nothing): keep scale 1 and carry no depths
            return 1.0, {}, 0
        k0 = np.asarray(kf_anchor.features["keypoints"])[i0[idx]]
        k1 = np.asarray(feats["keypoints"])[i1[idx]]
        d0, d1 = _two_view_depths(k0, k1, self.K,
                                  np.asarray(R, np.float64),
                                  np.asarray(t, np.float64))
        pos = (d0 > 1e-6) & (d1 > 1e-6)
        stored = self._kf_depths.setdefault(kf_anchor.index, {})
        # scale votes from BOTH endpoints: the anchor's depth map keyed by
        # i0, and — when the other endpoint is itself a keyframe (loop
        # edges) — that keyframe's map keyed by i1. A loop pair often
        # shares few points with the anchor's bookkept subset but many
        # with the new keyframe's (its odometry edge covers the same
        # viewpoint), so one-sided resolution starves loop edges.
        ratios = []
        if stored:
            prev = np.array([stored.get(int(i), np.nan) for i in i0[idx]])
            sel = pos & np.isfinite(prev)
            ratios.append(prev[sel] / d0[sel])
        if feats_kf_index is not None:
            stored1 = self._kf_depths.get(feats_kf_index, {})
            if stored1:
                prev1 = np.array([stored1.get(int(j), np.nan)
                                  for j in i1[idx]])
                sel1 = pos & np.isfinite(prev1)
                ratios.append(prev1[sel1] / d1[sel1])
        votes = np.concatenate(ratios) if ratios else np.zeros(0)
        s, n_shared = 1.0, int(len(votes))
        resolved = False
        if n_shared >= 5:
            s = float(np.clip(np.median(votes), 0.05, 20.0))
            resolved = True
        elif kf_anchor.index == 0 and not stored:
            # bootstrap anchor: its first edge DEFINES the global scale
            n_shared = int(pos.sum())
            resolved = True
        if resolved:
            # enrich the anchor's map ONLY with scale-resolved depths:
            # an unresolved edge triangulates at its own arbitrary unit
            # baseline, and storing those poisons the map — measured as
            # multiplicative scale runaway (|t| climbing to the 20x clip)
            for i, dv, p in zip(i0[idx], d0, pos):
                if p:
                    stored.setdefault(int(i), float(s * dv))
        new_depths = {int(j): float(s * dv)
                      for j, dv, p in zip(i1[idx], d1, pos) if p} \
            if resolved else {}
        return s, new_depths, n_shared

    def _verify_pair(self, kf_old: Keyframe, feats, match,
                     feats_kf_index: Optional[int] = None):
        """MNN + LO-RANSAC geometric verification against one keyframe.
        The returned relative pose carries the propagated monocular scale
        (anchored on kf_old's stored depths, plus the other endpoint's
        when it is itself a keyframe)."""
        with self._timed("match"):
            i0, i1 = match(kf_old.features, feats)
        if len(i0) < self.cfg.min_matches:
            return None
        with self._timed("pose"):
            res = self._estimate_edge(
                np.asarray(kf_old.features["keypoints"])[i0],
                np.asarray(feats["keypoints"])[i1])
            if res is None:
                return None
            R, t, mask = res
            s, pending, n_shared = self._edge_scale(
                kf_old, i0, i1, feats, R, t, mask,
                feats_kf_index=feats_kf_index)
        self._pending_depths = pending
        rel = se3_from_Rt(_f32(R), _f32(s * t)).numpy()
        return i0, i1, rel, mask, int(mask.sum()), n_shared

    def _try_loop_closure(self, new_idx: int, match) -> bool:
        """Detect + close a loop for the just-inserted keyframe `new_idx`:
        retrieval by pooled descriptor, geometric verification, loop edge,
        then full pose-graph optimization to spread the drift."""
        kf_new = self.keyframes[new_idx]
        cands = self._retrieve(kf_new.global_desc,
                               new_idx - self.cfg.loop_min_gap,
                               self.cfg.loop_candidates)
        closed = False
        for cand in cands:
            ver = self._verify_pair(self.keyframes[cand], kf_new.features,
                                    match, feats_kf_index=new_idx)
            if ver is None or ver[4] < self.cfg.loop_min_inliers:
                continue
            i0, i1, rel, mask, n_inl, n_shared = ver
            if n_shared < self.cfg.loop_min_scale_votes:
                # a loop edge whose translation scale could not be
                # resolved against the anchor's depth map would inject a
                # unit-norm guess into the pose graph — measured to
                # corrupt the whole trajectory; skip it
                continue
            rel_est = se3_compose(
                _f32(kf_new.pose6),
                se3_inverse(_f32(self.keyframes[cand].pose6)))
            rot_resid = float(np.degrees(np.linalg.norm(
                so3_log(so3_exp(_f32(rel[:3])).T
                        @ so3_exp(rel_est[:3])).numpy())))
            allowed = (self.cfg.loop_max_rot_residual_deg
                       + self.cfg.loop_rot_residual_per_gap_deg
                       * (new_idx - cand))
            if rot_resid > allowed:
                continue
            mask_idx = np.nonzero(mask)[0]
            self.pair_matches[(cand, new_idx)] = (i0[mask_idx], i1[mask_idx])
            self.graph.add_edge(cand, new_idx, rel,
                                weight=float(n_inl))
            closed = True
        if closed:
            self.n_loop_closures += 1
            with self._timed("pose_graph"):
                poses, _ = optimize_pose_graph(self.graph,
                                               device=self.device)
            self.graph.poses = np.array(poses)  # writable copy
            for kf in self.keyframes:
                kf.pose6 = poses[kf.index].astype(np.float32)
            self.current_pose = self.keyframes[-1].pose6.copy()
            with self._timed("window_ba"):
                self._window_ba()
        return closed

    def _relocalize(self, feats, match):
        """Search all keyframes for the lost frame; return the best anchor
        (kf, i0, i1, rel, mask, n_inl) or None."""
        gdesc = _global_desc(feats)
        cands = self._retrieve(gdesc, len(self.keyframes),
                               self.cfg.loop_candidates)
        best = None
        for cand in cands:
            ver = self._verify_pair(self.keyframes[cand], feats, match)
            if ver is None or ver[4] < self.cfg.reloc_min_inliers:
                continue
            if best is None or ver[4] > best[5]:
                i0, i1, rel, mask, n_inl, _n_shared = ver
                best = (self.keyframes[cand], i0, i1, rel, mask, n_inl)
                # _verify_pair set _pending_depths for THIS candidate;
                # snapshot it so a later (worse) candidate's verification
                # cannot leave its depths attached to the best anchor
                best_pending = dict(self._pending_depths)
        if best is not None:
            self._pending_depths = best_pending
        return best

    def _insert_keyframe(self, feats, pose6) -> int:
        # n_frames was already incremented for the frame being processed,
        # so the source frame number is n_frames - 1 (lets ATE harnesses
        # index ground-truth poses at the keyframed frames)
        self.keyframes.append(Keyframe(
            len(self.keyframes), feats, np.asarray(pose6, np.float32),
            _global_desc(feats), frame_id=self.n_frames - 1))
        self.graph.add_keyframe(pose6)
        return len(self.keyframes) - 1

    # ------------------------------------------------------------ window BA

    def _window_ba(self):
        cfg = self.cfg
        n_kf = len(self.keyframes)
        lo = max(0, n_kf - cfg.window)
        window = list(range(lo, n_kf))
        pairs = {(i - lo, j - lo): m
                 for (i, j), m in self.pair_matches.items()
                 if i in window and j in window}
        if not pairs:
            return
        kpts = [self.keyframes[i].features["keypoints"] for i in window]
        obs_cam, obs_pt, obs_uv, n_tracks, obs_kp = build_tracks(
            pairs, kpts, min_length=cfg.min_track_length, return_kp=True)
        if n_tracks < 8:
            return
        poses = np.stack([self.keyframes[i].pose6 for i in window])
        X = triangulate_tracks(obs_cam, obs_pt, obs_uv, n_tracks,
                               poses, self.K.astype(np.float32))
        good = np.isfinite(X).all(1) & (np.linalg.norm(X, axis=1) < 1e4)

        # observation-level gating: a wrong match chained into a track
        # triangulates to a point that projects kilometers off (or lands
        # behind a camera); one such observation seeds BA with ~1e8-px
        # residuals. Gate on per-observation depth + reprojection error
        # BEFORE the solve, then re-require min_track_length support.
        Ts = se3_matrix(_f32(poses)).numpy()                 # (W, 4, 4)
        Xh = np.concatenate([X, np.ones((len(X), 1), X.dtype)], 1)
        cam_pts = np.einsum("oij,oj->oi", Ts[obs_cam][:, :3, :],
                            Xh[obs_pt])
        z = cam_pts[:, 2]
        proj = cam_pts @ self.K.T
        uv = proj[:, :2] / np.maximum(proj[:, 2:], 1e-9)
        err = np.linalg.norm(uv - obs_uv, axis=1)
        ok_obs = good[obs_pt] & (z > cfg.ba_min_depth) \
            & (err < cfg.ba_max_reproj_px)
        support = np.bincount(obs_pt[ok_obs], minlength=len(X))
        good &= support >= cfg.min_track_length
        keep_obs = ok_obs & good[obs_pt]
        remap = np.cumsum(good) - 1
        obs_cam, obs_pt, obs_uv, obs_kp = (
            obs_cam[keep_obs], remap[obs_pt[keep_obs]].astype(np.int32),
            obs_uv[keep_obs], obs_kp[keep_obs])
        X = X[good]
        if len(X) < 8:
            return

        fixed = np.zeros(len(window), bool)
        fixed[0] = True
        # bucket point/observation counts to powers of two (masked
        # padding), as the JAX package does to reuse compiled programs: the
        # same padded problem gives the same sums
        n_obs = len(obs_cam)
        pt_cap = 1 << max(int(np.ceil(np.log2(max(len(X), 64)))), 6)
        obs_cap = 1 << max(int(np.ceil(np.log2(max(n_obs, 128)))), 7)
        Xp = np.zeros((pt_cap, 3), np.float32)
        Xp[:len(X)] = X
        Xp[len(X):, 2] = 1.0  # benign padding in front of the cameras
        oc = np.zeros(obs_cap, np.int32)
        op = np.zeros(obs_cap, np.int32)
        ouv = np.zeros((obs_cap, 2), np.float32)
        oc[:n_obs] = obs_cam
        op[:n_obs] = obs_pt
        ouv[:n_obs] = obs_uv
        omask = np.arange(obs_cap) < n_obs
        problem = BAProblem(
            cams=_f32(poses), points=torch.from_numpy(Xp),
            K=_f32(self.K), obs_cam=torch.from_numpy(oc).long(),
            obs_pt=torch.from_numpy(op).long(),
            obs_uv=torch.from_numpy(ouv), obs_mask=torch.from_numpy(omask),
            fixed_cams=torch.from_numpy(fixed)).to(self.device)
        self.last_ba_problem = problem
        solved, _ = bundle_adjust(problem, iters=cfg.ba_iters,
                                  cg_iters=cfg.cg_iters)
        self.last_ba_rmse = float(reprojection_rmse(solved))
        new_poses = solved.cams.cpu().numpy()
        for w_idx, kf_idx in enumerate(window):
            self.keyframes[kf_idx].pose6 = new_poses[w_idx]
            self.graph.poses[kf_idx] = new_poses[w_idx]
        self.current_pose = self.keyframes[-1].pose6.copy()

        # refresh the monocular-scale depth maps from the BA solution —
        # the BA map is the authoritative, scale-CONSISTENT local
        # geometry, so this both widens map coverage (all tracked
        # points, not one edge's inliers) and heals any cascade break in
        # the edge-to-edge propagation
        Ts_ba = se3_matrix(_f32(new_poses)).numpy()
        Xba = solved.points.cpu().numpy()
        n_obs2 = len(obs_cam)
        Xh2 = np.concatenate([Xba[obs_pt], np.ones((n_obs2, 1),
                                                   Xba.dtype)], 1)
        z_ba = np.einsum("oj,oj->o", Ts_ba[obs_cam][:, 2, :], Xh2)
        for c, k, zv in zip(obs_cam.tolist(), obs_kp.tolist(),
                            z_ba.tolist()):
            if zv > cfg.ba_min_depth:
                self._kf_depths.setdefault(window[c], {})[int(k)] = \
                    float(zv)

    # ------------------------------------------------------------ outputs

    def trajectory(self) -> np.ndarray:
        return np.stack([kf.pose6 for kf in self.keyframes]) \
            if self.keyframes else np.zeros((0, 6), np.float32)

    def keyframe_frame_ids(self) -> np.ndarray:
        """Source frame number of each keyframe — index ground-truth pose
        arrays with this when computing ATE (keyframes are a subset of
        frames, so gt[:n_keyframes] would compare the wrong poses)."""
        return np.asarray([kf.frame_id for kf in self.keyframes], np.int64)
