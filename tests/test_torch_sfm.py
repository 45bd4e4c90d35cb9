"""The port's SfM/SLAM layer (`accelerated_features_tpu_torch/sfm/`,
`train/render.py`, `apps/eval_slam.py`) against the JAX package's, on the
CPU. Every input is built here from numpy seeds and given to both
packages; the tolerances are stated in each test.

Both packages compute in float32 and sum in the same order on the CPU, so
single functions agree to float32 rounding. Solvers amplify rounding along
directions where the cost is flat (a window BA with one fixed camera
leaves the scale free), so where a problem leaves such a direction the
parameters are compared loosely and the costs tightly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerated_features_tpu import sfm as jsfm
from accelerated_features_tpu.sfm import ba as jba
from accelerated_features_tpu.sfm import slam as jslam
from accelerated_features_tpu.sfm import tracks as jtracks
from accelerated_features_tpu.train import render as jrender
from accelerated_features_tpu_torch import sfm
from accelerated_features_tpu_torch.sfm import ba, slam, tracks
from accelerated_features_tpu_torch.train import render
from accelerated_features_tpu_torch.utils.imageio import load_textures

from torch_support import HOLDOUT_SCENES, close

K_SYN = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])


# ---------------------------------------------------------------- fixtures

def _rot(w):
    """Rodrigues in float64 numpy."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def _project(pose6, X, K):
    """World points (n,3) through a world->cam pose6 -> (pixels, depths)."""
    Xc = X @ _rot(pose6[:3]).T + pose6[3:]
    uv = Xc @ K.T
    return uv[:, :2] / uv[:, 2:], Xc[:, 2]


def _ba_arrays(seed=0, n_cams=6, n_pts=120, noise_px=1.0, perturb=0.05,
               fixed=(0,), pad=0):
    """Cameras on an arc looking at a point cloud, noisy observations, a
    perturbed start; `fixed` cameras frozen; `pad` masked observations of
    garbage pixels appended."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3))
    cams_gt = np.zeros((n_cams, 6))
    for c in range(n_cams):
        cams_gt[c, :3] = [0, 0.1 * (c - n_cams / 2), 0]
        cams_gt[c, 3:] = [0.5 * (c - n_cams / 2), 0, 0]
    oc, op, uv = [], [], []
    for c in range(n_cams):
        px, _ = _project(cams_gt[c], X, K_SYN)
        vis = np.nonzero((px[:, 0] >= 0) & (px[:, 0] < 640)
                         & (px[:, 1] >= 0) & (px[:, 1] < 480))[0]
        oc += [c] * len(vis)
        op += vis.tolist()
        uv.append(px[vis] + rng.normal(0, noise_px, (len(vis), 2)))
    uv = np.concatenate(uv)
    cams0 = cams_gt + rng.normal(0, perturb, cams_gt.shape)
    cams0[0] = cams_gt[0]
    pts0 = X + rng.normal(0, 2 * perturb, X.shape)
    mask = np.ones(len(oc), bool)
    if pad:
        oc += [0] * pad
        op += [0] * pad
        uv = np.concatenate([uv, rng.uniform(0, 5000, (pad, 2))])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    fixed_cams = np.zeros(n_cams, bool)
    fixed_cams[list(fixed)] = True
    return {"cams": cams0.astype(np.float32),
            "points": pts0.astype(np.float32),
            "K": K_SYN.astype(np.float32),
            "obs_cam": np.asarray(oc, np.int32),
            "obs_pt": np.asarray(op, np.int32),
            "obs_uv": uv.astype(np.float32), "obs_mask": mask,
            "fixed_cams": fixed_cams}


def _jax_problem(a):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()})


def _port_problem(a):
    return ba.BAProblem(**{
        k: torch.from_numpy(v).long() if v.dtype == np.int32
        else torch.from_numpy(v) for k, v in a.items()})


# ---------------------------------------------------------------------- BA

def test_project_matches_jax():
    a = _ba_arrays(seed=1)
    cams = a["cams"][a["obs_cam"]]
    pts = a["points"][a["obs_pt"]]
    ref = jax.vmap(jba.project, (0, 0, None))(
        jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(a["K"]))
    got = ba.project(torch.from_numpy(cams), torch.from_numpy(pts),
                     torch.from_numpy(a["K"]))
    close(got, ref, 1e-6)


@pytest.mark.parametrize("kind", ["plain", "masked", "two fixed cameras"])
def test_residuals_and_jacobians_match_jax(kind):
    a = _ba_arrays(seed=2, pad=32 if kind == "masked" else 0,
                   fixed=(0, 1) if kind == "two fixed cameras" else (0,))
    if kind == "plain":
        a["fixed_cams"] = None
    ref = jba.residuals_and_jacobians(_jax_problem(
        {k: v for k, v in a.items() if v is not None}))
    got = ba.residuals_and_jacobians(_port_problem(
        {k: v for k, v in a.items() if v is not None}))
    for g, r in zip(got, ref):
        close(g, r, 1e-6)
    if kind == "masked":
        assert not got[0][~torch.from_numpy(a["obs_mask"])].any()
    if kind == "two fixed cameras":
        assert not got[1][torch.from_numpy(a["obs_cam"]) < 2].any()


def _blocks(seed=3):
    a = _ba_arrays(seed=seed, pad=16)
    ref = jba.build_normal_blocks(_jax_problem(a), 1e-3)
    got = ba.build_normal_blocks(_port_problem(a), 1e-3)
    return a, ref, got


def test_build_normal_blocks_matches_jax():
    """U, W, b_c, b_p and the cost to 2e-6 of their largest value; V^-1,
    a closed-form inverse whose determinant cancels, to 1e-5."""
    _, ref, got = _blocks()
    for g, r, rel in zip(got, ref, (2e-6, 1e-5, 2e-6, 2e-6, 2e-6, 2e-6)):
        close(g, r, rel)


def test_schur_matvec_matches_jax():
    a, ref, _ = _blocks()
    U, Vinv, W = (np.array(x) for x in ref[:3])
    x = np.random.default_rng(0).normal(size=(6, 6)).astype(np.float32)
    C, P = a["cams"].shape[0], a["points"].shape[0]
    want = jba.schur_matvec(jnp.asarray(x), U, Vinv, W,
                            jnp.asarray(a["obs_cam"]),
                            jnp.asarray(a["obs_pt"]), C, P)
    p = _port_problem(a)
    got = ba.schur_matvec(torch.from_numpy(x), *map(torch.from_numpy,
                                                    (U, Vinv, W)),
                          p.obs_cam, p.obs_pt, ba.segment_tables(p))
    close(got, want, 1e-5)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_solve_matches_jax(precond):
    """12 iterations on a seeded SPD operator over (6, 6) camera-space
    vectors (condition number ~400), plain or with block-Jacobi on its 6x6
    diagonal blocks: to 1e-5 of the solution's largest value."""
    rng = np.random.default_rng(1)
    M = rng.normal(size=(36, 36))
    A = (M @ M.T / 36 + 0.01 * np.eye(36)).astype(np.float32)
    b = rng.normal(size=(6, 6)).astype(np.float32)
    Minv = np.linalg.inv(np.stack([A[6 * c:6 * c + 6, 6 * c:6 * c + 6]
                                   for c in range(6)])).astype(np.float32)
    t = torch.from_numpy
    want = jba.cg_solve(
        lambda x: (A @ x.reshape(-1)).reshape(6, 6), jnp.asarray(b), 12,
        precond_mv=(lambda r: jnp.einsum("cij,cj->ci", Minv, r))
        if precond else None)
    got = ba.cg_solve(
        lambda x: (t(A) @ x.reshape(-1)).reshape(6, 6), t(b), 12,
        precond_mv=(lambda r: torch.einsum("cij,cj->ci", t(Minv), r))
        if precond else None)
    close(got, want, 1e-5)
    exact = np.linalg.solve(A.astype(np.float64), b.reshape(-1).astype(
        np.float64)).reshape(6, 6)
    assert np.abs(got.numpy() - exact).max() < np.abs(exact).max()


def test_ba_step_matches_jax():
    """One LM step from the perturbed start, a long one (up to 1.7 in the
    camera parameters): the cost to 1e-6, the new parameters to 1e-3 of
    their largest value. Each package's float32 step is 2e-4 to 7e-4 from
    the port's float64 solve of it, so 1e-3 is float32's own error."""
    a = _ba_arrays(seed=4, fixed=(0, 1))
    want, wcost = jba.ba_step(_jax_problem(a), 1e-3, 25)
    got, gcost = ba.ba_step(_port_problem(a), 1e-3, 25)
    close(gcost, wcost, 1e-6)
    close(got.cams, want.cams, 1e-3)
    close(got.points, want.points, 1e-3)


def _jax_bundle_adjust(a, **kw):
    return jax.jit(lambda p: jba.bundle_adjust(p, **kw))(_jax_problem(a))


def test_bundle_adjust_matches_jax():
    """Gauge fixed by two frozen cameras: parameters to 1e-4 of their
    largest value, cost to 1e-4, RMSE to 1e-4."""
    a = _ba_arrays(seed=0, fixed=(0, 1))
    want, winfo = _jax_bundle_adjust(a, iters=15, cg_iters=40)
    got, ginfo = ba.bundle_adjust(_port_problem(a), iters=15, cg_iters=40)
    for k in ("initial_cost", "final_cost", "final_lambda"):
        close(ginfo[k], winfo[k], 1e-4)
    close(got.cams, want.cams, 1e-4)
    close(got.points, want.points, 1e-4)
    close(ba.reprojection_rmse(got), jba.reprojection_rmse(want), 1e-4)
    assert float(ba.reprojection_rmse(got)) < 2.0   # ~noise level (1 px)
    assert float(ginfo["final_cost"]) < float(ginfo["initial_cost"]) / 9


def test_bundle_adjust_free_scale_matches_jax_in_cost():
    """One frozen camera leaves the scale free: the costs agree to 1e-4,
    the parameters to 1e-2 of their largest value."""
    a = _ba_arrays(seed=0)
    want, winfo = _jax_bundle_adjust(a, iters=15, cg_iters=40)
    got, ginfo = ba.bundle_adjust(_port_problem(a), iters=15, cg_iters=40)
    close(ginfo["final_cost"], winfo["final_cost"], 1e-4)
    close(ba.reprojection_rmse(got), jba.reprojection_rmse(want), 1e-4)
    close(got.cams, want.cams, 1e-2)


def test_bundle_adjust_ignores_masked_garbage_observations():
    """64 masked observations of garbage pixels change nothing: the padded
    and unpadded problems solve to 1e-4 of each other in the port (as in
    the JAX package's own test), and the padded one to JAX's."""
    plain = _ba_arrays(seed=3, fixed=(0, 1))
    padded = _ba_arrays(seed=3, fixed=(0, 1), pad=64)
    s1, _ = ba.bundle_adjust(_port_problem(plain), iters=5, cg_iters=30)
    s2, info = ba.bundle_adjust(_port_problem(padded), iters=5, cg_iters=30)
    np.testing.assert_allclose(s2.cams.numpy(), s1.cams.numpy(), atol=1e-4)
    want, winfo = _jax_bundle_adjust(padded, iters=5, cg_iters=30)
    close(s2.cams, want.cams, 1e-4)
    close(info["final_cost"], winfo["final_cost"], 1e-4)
    close(ba.reprojection_rmse(s2), jba.reprojection_rmse(want), 1e-4)


def test_block_jacobi_pcg_converges_faster():
    """PCG at 20 iterations reaches plain CG's cost at 50."""
    p = _port_problem(_ba_arrays())
    _, plain = ba.bundle_adjust(p, iters=6, cg_iters=50, precond=False)
    _, pcg = ba.bundle_adjust(p, iters=6, cg_iters=20, precond=True)
    assert float(pcg["final_cost"]) <= 1.02 * float(plain["final_cost"])


def test_ba_problem_to_moves_every_tensor():
    p = _port_problem(_ba_arrays())
    assert all(t.device.type == "meta" for t in p.to("meta"))
    q = ba.BAProblem(*p[:7]).to("meta")
    assert q.fixed_cams is None and q.cams.device.type == "meta"


# --------------------------------------------------------------- pose graph

def _ring_graph(graph_cls, n=10, false_edge=True, seed=6):
    """Keyframes on a circle with noisy odometry, one true loop edge and,
    optionally, one false loop edge ~1 rad off."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n, 6))
    for i in range(n):
        th = 1.6 * np.pi * i / n
        gt[i, :3] = [0, -th, 0]
        gt[i, 3:] = -_rot(gt[i, :3]) @ (3.0 * np.array([np.sin(th), 0,
                                                        np.cos(th) - 1]))

    def rel(i, j):   # T_j T_i^-1 as a pose6
        Ri, Rj = _rot(gt[i, :3]), _rot(gt[j, :3])
        R = Rj @ Ri.T
        t = gt[j, 3:] - R @ gt[i, 3:]
        return R, t

    def pose6(R, t):
        c = np.clip((np.trace(R) - 1) / 2, -1, 1)
        th = np.arccos(c)
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        w = w * (th / (2 * np.sin(th)) if th > 1e-7 else 0.5)
        return np.concatenate([w, t]).astype(np.float32)

    g = graph_cls.empty()
    noisy = gt + rng.normal(0, 0.03, gt.shape)
    noisy[0] = gt[0]
    for i in range(n):
        g.add_keyframe(noisy[i].astype(np.float32))
    for i in range(n - 1):
        R, t = rel(i, i + 1)
        g.add_edge(i, i + 1, pose6(R, t + rng.normal(0, 0.02, 3)))
    R, t = rel(0, n - 1)
    g.add_edge(0, n - 1, pose6(R, t), weight=2.0)
    if false_edge:
        R, t = rel(2, 6)
        g.add_edge(2, 6, pose6(_rot([0.0, 1.0, 0.0]) @ R, t), weight=1.0)
    return g, gt.astype(np.float32)


@pytest.mark.parametrize("robust_c", [0.7, None])
def test_optimize_pose_graph_matches_jax(robust_c):
    """Poses to 1e-4 of their largest value, costs to 1e-4."""
    jg, gt = _ring_graph(jsfm.PoseGraph)
    pg, _ = _ring_graph(sfm.PoseGraph)
    want, winfo = jsfm.optimize_pose_graph(jg, iters=20, robust_c=robust_c)
    got, ginfo = sfm.optimize_pose_graph(pg, iters=20, robust_c=robust_c,
                                         device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    close(got, want, 1e-4)
    for k in ("initial_cost", "final_cost"):
        assert ginfo[k] == pytest.approx(winfo[k], rel=1e-4)
    assert ginfo["final_cost"] < ginfo["initial_cost"]


def test_robust_pose_graph_resists_the_false_loop_edge():
    """With the Cauchy weights the false edge bends the ring less than
    plain least squares does, in both packages."""
    out = {}
    for name, mod, kw in (("jax", jsfm, {}), ("port", sfm, {"device": "cpu"})):
        for c in (0.7, None):
            g, gt = _ring_graph(mod.PoseGraph)
            poses, _ = mod.optimize_pose_graph(g, iters=20, robust_c=c, **kw)
            out[name, c] = sfm.absolute_trajectory_error(poses, gt)
    for name in ("jax", "port"):
        assert out[name, 0.7] < out[name, None]
    assert out["port", 0.7] == pytest.approx(out["jax", 0.7], rel=1e-3)


def test_absolute_trajectory_error_matches_jax():
    """Zero under a similarity transform of the trajectory, and the JAX
    value on a noisy estimate."""
    rng = np.random.default_rng(7)
    gt = (rng.normal(size=(12, 6)) * 0.3).astype(np.float32)
    Q, s, u = _rot([0.3, -0.2, 0.5]), 2.5, np.array([1.0, -2.0, 0.5])
    est = np.zeros_like(gt)
    for i, p in enumerate(gt.astype(np.float64)):
        R = _rot(p[:3])
        c = s * Q @ (-R.T @ p[3:]) + u
        R2 = R @ Q.T
        w = sfm.so3_log(torch.as_tensor(R2, dtype=torch.float32)).numpy()
        est[i] = np.concatenate([w, -R2 @ c])
    assert sfm.absolute_trajectory_error(est, gt) < 1e-4
    noisy = est + (rng.normal(size=est.shape) * 0.05).astype(np.float32)
    assert sfm.absolute_trajectory_error(noisy, gt) == pytest.approx(
        jsfm.absolute_trajectory_error(noisy, gt), rel=1e-5)


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = _ring_graph(sfm.PoseGraph, n=4, false_edge=False)
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0, 600, (50, 2))
    from accelerated_features_tpu_torch.apps import eval_slam
    for call in (lambda: sfm.IncrementalSlam(K_SYN),
                 lambda: sfm.optimize_pose_graph(g),
                 lambda: sfm.two_view_reconstruction(p0, p0 + 3, K_SYN),
                 lambda: eval_slam.main(["--textures", str(HOLDOUT_SCENES)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ------------------------------------------------------- tracks, two-view

def _pair_matches(seed=8):
    """Random pairwise matches over 4 frames, with conflicts (two
    keypoints of one frame chained into one track)."""
    rng = np.random.default_rng(seed)
    kpts = [rng.uniform(0, 640, (40, 2)).astype(np.float32)
            for _ in range(4)]
    matches = {}
    for i, j in ((0, 1), (1, 2), (2, 3), (0, 2), (1, 3)):
        a = rng.choice(40, 25, replace=False)
        b = rng.choice(40, 25, replace=False)
        matches[(i, j)] = (a, b)
    return matches, kpts


@pytest.mark.parametrize("min_length", [2, 3])
@pytest.mark.parametrize("return_kp", [False, True])
def test_build_tracks_equals_jax(min_length, return_kp):
    matches, kpts = _pair_matches()
    want = jtracks.build_tracks(matches, kpts, min_length, return_kp)
    got = tracks.build_tracks(matches, kpts, min_length, return_kp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w
    # a conflict drops the track
    conflict = {(0, 1): (np.array([0, 1]), np.array([0, 0]))}
    assert tracks.build_tracks(conflict, [np.zeros((3, 2))] * 2)[3] == 0


def test_triangulate_tracks_matches_jax():
    rng = np.random.default_rng(11)
    n_cams, n_pts = 4, 60
    X = rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3))
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 1] = np.linspace(-0.1, 0.1, n_cams)
    cams[:, 3] = np.linspace(-1, 1, n_cams)
    kpts = [_project(c.astype(np.float64), X, K_SYN)[0].astype(np.float32)
            for c in cams]
    matches = {(c, c + 1): (np.arange(n_pts), np.arange(n_pts))
               for c in range(n_cams - 1)}
    oc, op, uv, n = tracks.build_tracks(matches, kpts, min_length=3)
    K = K_SYN.astype(np.float32)
    want = jtracks.triangulate_tracks(oc, op, uv, n, cams, K)
    got = tracks.triangulate_tracks(oc, op, uv, n, cams, K)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, X, atol=2e-3)


def test_triangulate_linear_equals_jax():
    rng = np.random.default_rng(2)
    R, t = _rot([0.0, 0.1, 0.0]), np.array([0.5, 0, 0])
    X = rng.uniform([-1, -1, 5], [1, 1, 8], (30, 3))
    P0 = K_SYN @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K_SYN @ np.hstack([R, t[:, None]])
    x0 = _project(np.zeros(6), X, K_SYN)[0]
    x1 = (P1 @ np.hstack([X, np.ones((30, 1))]).T).T
    x1 = x1[:, :2] / x1[:, 2:]
    got = sfm.triangulate_linear(P0, P1, x0, x1)
    assert np.array_equal(got, jsfm.triangulate_linear(P0, P1, x0, x1))
    np.testing.assert_allclose(got, X, atol=1e-6)


def test_two_view_reconstruction_matches_jax():
    """posekit in both packages (same source, same seed): the same inlier
    mask and triangulated points bit for bit; then the BA of the two
    problems agrees in cost to 1e-4 and reaches the noise level."""
    rng = np.random.default_rng(4)
    R, t = _rot([0.05, -0.15, 0.02]), np.array([0.6, 0.1, 0.05])
    X = rng.uniform([-2, -2, 5], [2, 2, 10], (200, 3))
    p0 = _project(np.zeros(6), X, K_SYN)[0] + rng.normal(0, 0.5, (200, 2))
    Xc = X @ R.T + t
    p1 = (Xc @ K_SYN.T)[:, :2] / Xc[:, 2:] + rng.normal(0, 0.5, (200, 2))
    p1[:30] = rng.uniform(0, 640, (30, 2))
    want = jsfm.two_view_reconstruction(p0, p1, K_SYN)
    got = sfm.two_view_reconstruction(p0, p1, K_SYN, device="cpu")
    assert want is not None and got is not None
    (wp, wmask), (gp, gmask) = want, got
    assert np.array_equal(gmask, wmask) and gmask.sum() > 120
    assert np.array_equal(gp.points.numpy(), np.asarray(wp.points))
    assert np.array_equal(gp.obs_uv.numpy(), np.asarray(wp.obs_uv))
    close(gp.cams, wp.cams, 1e-6)
    assert gp.fixed_cams.tolist() == [True, False]
    ws, winfo = jax.jit(lambda p: jba.bundle_adjust(p, iters=10,
                                                    cg_iters=30))(wp)
    gs, ginfo = ba.bundle_adjust(gp, iters=10, cg_iters=30)
    close(ginfo["final_cost"], winfo["final_cost"], 1e-4)
    assert float(ba.reprojection_rmse(gs)) < 1.5


# ---------------------------------------------------------------- SLAM

def _ring_points(rng, n_pts):
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = rng.uniform(7, 11, n_pts)
    X = np.stack([rad * np.sin(ang), rng.uniform(-3, 3, n_pts),
                  rad * np.cos(ang)], -1)
    descs = rng.normal(size=(n_pts, 64)).astype(np.float32)
    return X, descs / np.linalg.norm(descs, axis=1, keepdims=True)


def _features(pose, X, rng, noise, descs=None, in_front=False):
    """The keypoints of the points `X` visible from `pose`, projected in
    float32 by the port's `project` (the JAX package's tests project in
    float32 too), with `noise` px of Gaussian noise."""
    pose = pose.astype(np.float32)
    uv = sfm.project(torch.from_numpy(pose),
                     torch.from_numpy(X.astype(np.float32)),
                     torch.from_numpy(K_SYN.astype(np.float32))).numpy()
    vis = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
    if in_front:
        R = sfm.so3_exp(torch.from_numpy(pose[:3])).numpy()
        vis &= (X @ R.T + pose[3:])[:, 2] > 0.5
    ids = np.nonzero(vis)[0]
    kp = uv[ids] + (rng.normal(0, noise, (len(ids), 2)) if noise else 0)
    f = {"keypoints": kp.astype(np.float32), "ids": ids}
    if descs is not None:
        f["descriptors"] = descs[ids]
    return pose, f


def _orbit_frame(th, X, descs, rng, noise):
    """A camera at angle th on a circle of radius 2 looking outwards."""
    c = 2.0 * np.array([np.sin(th), 0.0, np.cos(th)])
    aa = np.array([0.0, -th, 0.0], np.float32)
    R = sfm.so3_exp(torch.from_numpy(aa)).numpy()
    return _features(np.concatenate([aa, -R @ c]), X, rng, noise, descs,
                     in_front=True)


def _scenario(name):
    """(features per frame, ground-truth poses, SlamConfig keywords) of
    the three synthetic scenarios: incremental tracking, a loop around a
    ring of landmarks, and a teleport back to the start."""
    if name == "tracking":
        rng = np.random.default_rng(0)
        X = rng.uniform([-3, -3, 6], [3, 3, 14], (400, 3))
        gt, feats = zip(*[_features(np.array([0, 0.04 * i, 0, 0.3 * i,
                                              0.02 * i, 0]), X, rng, 0.3)
                          for i in range(12)])
        return list(feats), np.asarray(gt), {
            "kf_min_inliers": 10_000, "window": 4}
    if name in ("odometry", "loop closure"):
        rng = np.random.default_rng(3)
        X, descs = _ring_points(rng, 900)
        gt, feats = zip(*[_orbit_frame(2 * np.pi * i / 14, X, descs, rng,
                                       0.8) for i in range(14)])
        return list(feats), np.asarray(gt), {
            "kf_min_inliers": 10_000, "window": 4,
            "enable_loop_closure": name == "loop closure",
            "loop_min_sim": 0.05, "loop_min_gap": 4, "loop_candidates": 3,
            "loop_min_inliers": 20}
    rng = np.random.default_rng(4)
    X, descs = _ring_points(rng, 700)
    angles = [0.0, 0.12, 0.24, 0.36, 0.6, 0.85, 1.1, 1.35, 0.05]
    gt, feats = zip(*[_orbit_frame(a, X, descs, rng, 0.0) for a in angles])
    return list(feats), np.asarray(gt), {
        "kf_min_inliers": 10_000, "window": 4, "enable_loop_closure": True,
        "loop_min_sim": 0.05, "loop_min_gap": 10, "reloc_min_inliers": 15}


def _id_match(d0, d1):
    _, a, b = np.intersect1d(d0["ids"], d1["ids"], return_indices=True)
    return a, b


def _run_both(feats, cfg_kw, K=K_SYN, match=_id_match):
    """Both packages' trackers on the same injected features."""
    out = {}
    for name, mod, kw in (("jax", jslam, {}),
                          ("port", slam, {"device": "cpu"})):
        it = iter(feats)
        tracker = mod.IncrementalSlam(
            K, mod.SlamConfig(**cfg_kw), extract=lambda _im: next(it),
            match=match, **kw)
        out[name] = (tracker, [tracker.process_frame(None) for _ in feats])
    return out


def _extent(poses):
    """Diagonal of the bounding box of the camera centers."""
    R = sfm.so3_exp(torch.as_tensor(poses[:, :3])).numpy()
    c = np.stack([-R[i].T @ poses[i, 3:] for i in range(len(poses))])
    return float(np.linalg.norm(np.ptp(c, axis=0)))


def _same_run(out, traj_tol, rmse_tol):
    """Equal discrete outcomes; the port's keyframe trajectory within
    `traj_tol` of the JAX package's extent of it after a similarity
    alignment (ATE of one against the other: the window BA leaves the
    scale free, and rounding moves each package's solution along it); the
    last window BA's RMSE within `rmse_tol` px."""
    (jt, jouts), (pt, pouts) = out["jax"], out["port"]
    assert len(pt.keyframes) == len(jt.keyframes)
    assert pt.n_loop_closures == jt.n_loop_closures
    assert pt.n_relocalizations == jt.n_relocalizations
    for k in ("is_keyframe", "n_inliers", "loop_closed", "relocalized"):
        assert [o[k] for o in pouts] == [o[k] for o in jouts], k
    assert np.array_equal(pt.keyframe_frame_ids(), jt.keyframe_frame_ids())
    gap = sfm.absolute_trajectory_error(pt.trajectory(), jt.trajectory())
    assert gap <= traj_tol * _extent(jt.trajectory()), gap
    assert abs(pt.last_ba_rmse - jt.last_ba_rmse) <= rmse_tol
    assert all(set(o["ms"]) == {*slam.STAGES, "total"} for o in pouts)


@pytest.fixture(scope="module")
def scenario_runs():
    """Both trackers on each scenario, run once for the module."""
    runs = {}

    def get(name):
        if name not in runs:
            feats, gt, cfg = _scenario(name)
            runs[name] = (_run_both(feats, cfg), gt)
        return runs[name]
    return get


@pytest.mark.parametrize("name", ["tracking", "odometry", "loop closure",
                                  "relocalization"])
def test_slam_scenarios_match_jax(name, scenario_runs):
    """Keyframes, loop closures and relocalizations equal; trajectories
    within 1e-2 of their extent after a similarity alignment (measured: at
    most 4.8e-3, in the loop); the last window BA's RMSE within 1e-3 px
    (measured: under 1e-6)."""
    out, gt = scenario_runs(name)
    _same_run(out, 1e-2, 1e-3)
    pt = out["port"][0]
    assert pt.last_ba_rmse is not None and pt.last_ba_rmse < 2.0
    if name == "tracking":
        assert len(pt.keyframes) >= 11
        ate = sfm.absolute_trajectory_error(
            pt.trajectory(), gt[pt.keyframe_frame_ids()])
        assert ate < 0.2
    if name == "loop closure":
        assert pt.n_loop_closures >= 1
    if name == "relocalization":
        assert pt.n_relocalizations >= 1
        assert any(o["relocalized"] for o in out["port"][1])


def test_slam_loop_closure_collapses_drift_in_both(scenario_runs):
    """The assertions of the JAX package's own test, on both packages."""
    ate = {}
    for name in ("odometry", "loop closure"):
        out, gt = scenario_runs(name)
        for pkg, (tracker, _) in out.items():
            ate[pkg, name] = sfm.absolute_trajectory_error(
                tracker.trajectory(), gt[tracker.keyframe_frame_ids()])
    for pkg in ("jax", "port"):
        assert out[pkg][0].n_loop_closures >= 1
        assert ate[pkg, "loop closure"] < 0.75 * ate[pkg, "odometry"]
        assert ate[pkg, "loop closure"] < 0.25


# ----------------------------------------------- rendered frames, real XFeat

@pytest.fixture(scope="module")
def rendered():
    """An 8-frame 320x240 loop through a scene textured with crops of the
    holdout PNGs, rendered by both packages from the same draws."""
    texs = load_textures(HOLDOUT_SCENES, 16, np.random.default_rng(3))
    trajs = [r.render_trajectory(np.random.default_rng(30), texs, 8, 320,
                                 240, n_quads=16, arc_deg=35.0, loop=True)
             for r in (render, jrender)]
    return trajs


def test_render_trajectory_equals_jax(rendered):
    got, want = rendered
    assert got["images"].shape == (8, 240, 320, 3)
    for k in ("images", "poses", "K"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def xfeat_cpu():
    from accelerated_features_tpu_torch import XFeat
    return XFeat(top_k=512, device="cpu")


@pytest.fixture(scope="module")
def rendered_features(rendered, xfeat_cpu):
    """The port's XFeat features of the rendered frames (trained weights,
    top_k 512), its MNN matcher and the frames' K."""
    traj = rendered[0]
    extract, match = slam.xfeat_frontend(xfeat_cpu)
    return [extract(im) for im in traj["images"]], match, traj["K"]


def test_slam_on_rendered_frames_matches_jax(rendered_features):
    """The rendered frames' features injected into both trackers with the
    port's MNN: equal discrete outcomes; trajectories within 3e-2 of their
    extent after a similarity alignment (measured 1.4e-2: the window BAs
    of real matches start farther from their optimum, and each package's
    rounding moves its scale differently from the third window on); the
    last window BA's RMSE within 0.2 px (measured 0.09 px, after a loop
    closure)."""
    feats, match, K = rendered_features
    out = _run_both(feats, {}, K=K, match=match)
    _same_run(out, 3e-2, 0.2)
    assert len(out["port"][0].keyframes) >= 2


def _port_run_on_threads(feats, match, K, threads):
    """The port's tracker on injected features with a torch pool of
    `threads`; the caller's pool size is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        it = iter(feats)
        tracker = slam.IncrementalSlam(
            K, slam.SlamConfig(), extract=lambda _im: next(it), match=match,
            device="cpu")
        return tracker, [tracker.process_frame(None) for _ in feats]
    finally:
        torch.set_num_threads(n)


def test_slam_answer_does_not_depend_on_the_pool_size(rendered_features):
    """The port's tracker on the rendered frames' injected features with
    torch pools of 1 and 8 threads: the same keyframes, inliers, loop
    closures and relocalizations, and the trajectory and the last window
    BA's RMSE equal bit for bit. CPU reductions that group their terms by
    the pool's size once gave the third window BA's normal blocks another
    rounding (7.9e-7 relative), which the solve grew to 0.22 in a camera
    and the tracker to a second loop closure on one thread."""
    runs = [_port_run_on_threads(*rendered_features, n) for n in (1, 8)]
    (t1, o1), (t8, o8) = runs
    assert t1.keyframe_frame_ids().tolist() == t8.keyframe_frame_ids().tolist()
    for k in ("is_keyframe", "n_inliers", "loop_closed", "relocalized"):
        assert [o[k] for o in o1] == [o[k] for o in o8], k
    assert t1.n_loop_closures == t8.n_loop_closures
    assert t1.n_relocalizations == t8.n_relocalizations
    assert np.array_equal(t1.trajectory(), t8.trajectory())
    assert t1.last_ba_rmse == t8.last_ba_rmse


@pytest.fixture(scope="module")
def default_run(rendered):
    """The tracker's own front end, `XFeat(top_k=2048)` with the trained
    weights, over the rendered frames on the CPU (loop closure off)."""
    traj = rendered[0]
    tracker = sfm.IncrementalSlam(
        traj["K"], sfm.SlamConfig(enable_loop_closure=False), device="cpu")
    return tracker, [tracker.process_frame(im) for im in traj["images"]]


def test_slam_default_frontend_on_cpu(default_run):
    tracker, outs = default_run
    est = tracker.trajectory()
    assert len(est) >= 2 and np.isfinite(est).all()
    assert tracker.last_ba_rmse is not None and tracker.last_ba_rmse < 2.0
    assert min(o["n_inliers"] for o in outs[1:]) >= 20
    assert tracker.last_ba_problem.cams.device.type == "cpu"
    assert outs[-1]["ms"]["extract"] > 0


def test_window_ba_problem_matches_jax(default_run):
    """The last window BA of the real front end's run (6 cameras, one
    fixed; 1024 padded points, 2048 padded observations), solved as the
    tracker solves it (6 LM, 25 CG iterations) by both packages: the final
    cost and RMSE within 1e-3 relative, the cameras within 1e-2 of their
    largest value. Measured: 2.8e-4, 1.4e-4 and 3.7e-4; the port's float64
    solve is 1.6e-3 from both in cost, since 6 LM steps stop short of the
    optimum along the free scale. The card's solve is held to the same
    gates (`chip_smoke.py`)."""
    p = default_run[0].last_ba_problem
    jp = jba.BAProblem(*(jnp.asarray(t.numpy().astype(np.int32)
                                     if t.dtype == torch.int64
                                     else t.numpy()) for t in p))
    want, winfo = jax.jit(lambda q: jba.bundle_adjust(q, iters=6,
                                                      cg_iters=25))(jp)
    got, ginfo = ba.bundle_adjust(p, iters=6, cg_iters=25)
    assert float(ginfo["final_cost"]) < float(ginfo["initial_cost"])
    assert float(ginfo["final_cost"]) == pytest.approx(
        float(winfo["final_cost"]), rel=1e-3)
    assert float(ba.reprojection_rmse(got)) == pytest.approx(
        float(jba.reprojection_rmse(want)), rel=1e-3)
    close(got.cams, want.cams, 1e-2)


def test_eval_slam_app_on_cpu(tmp_path):
    """The port's SLAM benchmark CLI at a small size on the CPU."""
    import json

    from accelerated_features_tpu_torch.apps import eval_slam
    res = eval_slam.main(["--textures", str(HOLDOUT_SCENES), "--frames", "6",
                          "--res", "320x240", "--seed", "3", "--top_k",
                          "512", "--device", "cpu", "--json",
                          str(tmp_path / "out.json")])
    assert json.loads((tmp_path / "out.json").read_text()) == res
    for tag in ("odometry", "loop_closure"):
        r = res[tag]
        assert r["device"] == "cpu" and r["n_keyframes"] >= 2
        assert np.isfinite(r["ate_rmse"]) and r["mean_inliers"] > 20
        assert set(r["median_ms_per_frame"]) == {*slam.STAGES, "total"}
    assert res["odometry"]["n_loop_closures"] == 0
