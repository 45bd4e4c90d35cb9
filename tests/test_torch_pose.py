"""The port's posekit wrapper (`geometry/pose.py`) against the JAX
package's, on the CPU. Both load a library compiled by g++ with the same
flags from the same `native/posekit.cpp` on the same machine, so the same
points and seeds must give equal results under `np.array_equal`. Scenes
are built here from numpy seeds, as `tests/test_geometry.py` builds its
own."""

from pathlib import Path

import numpy as np
import pytest

from accelerated_features_tpu.eval import megadepth1500 as jax_md
from accelerated_features_tpu.geometry import pose as jax_pose
from accelerated_features_tpu_torch.eval import megadepth1500 as md
from accelerated_features_tpu_torch.geometry import get_pose_estimator
from accelerated_features_tpu_torch.geometry import pose

PKG = Path(pose.__file__).resolve().parents[1]


def _axis_rot(ax, ang):
    c, s = np.cos(ang), np.sin(ang)
    if ax == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if ax == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _synth_scene(n=300, outlier_frac=0.3, noise_px=0.5, seed=0):
    """Two views of random 3D points with pixel noise, a share of the
    second view's points replaced by uniform outliers:
    (p0, p1, K, R, t)."""
    rng = np.random.default_rng(seed)
    R = _axis_rot(0, 0.12) @ _axis_rot(1, -0.25) @ _axis_rot(2, 0.06)
    t = np.array([0.4, -0.15, 0.1])
    t /= np.linalg.norm(t)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x0c = X / X[:, 2:]
    x1c = (R @ X.T).T + t
    x1c = x1c / x1c[:, 2:]
    p0 = (K @ x0c.T).T[:, :2] + rng.normal(0, noise_px, (n, 2))
    p1 = (K @ x1c.T).T[:, :2] + rng.normal(0, noise_px, (n, 2))
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    p1[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return p0, p1, K, R, t


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("seed,outliers,thr,rseed", [
    (0, 0.3, 2.5, 0), (3, 0.4, 1.5, 0), (5, 0.5, 2.5, 7), (8, 0.0, 1.0, 3)])
def test_relative_pose_equals_jax(seed, outliers, thr, rseed):
    p0, p1, K, *_ = _synth_scene(seed=seed, outlier_frac=outliers)
    ref = jax_pose.estimate_relative_pose(p0, p1, K, K, thr, seed=rseed)
    got = pose.estimate_relative_pose(p0, p1, K, K, thr, seed=rseed)
    assert got is not None
    _equal(got, ref)
    R, t, mask = got
    assert R.shape == (3, 3) and t.shape == (3,) and mask.shape == (300,)
    assert pose.estimate_relative_pose(p0[:4], p1[:4], K, K) is None
    with pytest.raises(ValueError):
        pose.estimate_relative_pose(p0, p1[:-1], K, K)


@pytest.mark.parametrize("seed,thresh", [(1, 3.0), (2, 4.0)])
def test_homography_equals_jax(seed, thresh):
    rng = np.random.default_rng(seed)
    H_gt = np.array([[1.1, 0.05, 20.0], [-0.03, 0.95, -10.0],
                     [1e-4, -5e-5, 1.0]])
    p0 = rng.uniform([0, 0], [640, 480], (200, 2))
    ph = np.concatenate([p0, np.ones((200, 1))], 1) @ H_gt.T
    p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (200, 2))
    bad = rng.choice(200, 60, replace=False)
    p1[bad] = rng.uniform([0, 0], [640, 480], (60, 2))
    got = pose.estimate_homography(p0, p1, thresh=thresh)
    assert got is not None and got[1].sum() >= 120
    _equal(got, jax_pose.estimate_homography(p0, p1, thresh=thresh))
    assert pose.estimate_homography(p0[:3], p1[:3]) is None


def test_five_point_and_sampson_equal_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        p0, p1, K, *_ = _synth_scene(n=5, outlier_frac=0.0, noise_px=0.0,
                                     seed=int(rng.integers(1 << 30)))
        x0 = (p0 - K[:2, 2]) / K[0, 0]
        x1 = (p1 - K[:2, 2]) / K[0, 0]
        Es = pose.five_point(x0, x1)
        assert len(Es) >= 1
        assert np.array_equal(Es, jax_pose.five_point(x0, x1))
        for E in Es:
            for i in range(5):
                assert pose.sampson_sq(E, x0[i], x1[i]) == \
                    jax_pose.sampson_sq(E, x0[i], x1[i])
    with pytest.raises(ValueError):
        pose.five_point(np.zeros((4, 2)), np.zeros((5, 2)))


def _rot(w):
    th = np.linalg.norm(w)
    ax = w / th
    Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                   [-ax[1], ax[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def test_decompose_homography_equals_jax():
    """Plane-induced homographies with and without sign-fixing points, and
    a pure rotation: the same candidate lists."""
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    cases = []
    for _ in range(10):
        R = _rot(rng.normal(size=3) * 0.2)
        t = rng.normal(size=3)
        n = rng.normal(size=3)
        n[2] = abs(n[2]) + 1.0
        n /= np.linalg.norm(n)
        H = K @ (R + np.outer(t, n) / rng.uniform(2.0, 6.0)) \
            @ np.linalg.inv(K)
        p0 = rng.uniform([0, 0], [640, 480], (12, 2))
        ph = np.concatenate([p0, np.ones((12, 1))], 1) @ H.T
        cases += [(H, p0, ph[:, :2] / ph[:, 2:]), (H, None, None)]
    cases.append((K @ _rot(np.array([0.05, -0.1, 0.02]))
                  @ np.linalg.inv(K), None, None))
    for H, p0, p1 in cases:
        got = pose.decompose_homography(H, K, K, p0, p1)
        ref = jax_pose.decompose_homography(H, K, K, p0, p1)
        assert len(got) == len(ref) in (1, 4)
        for a, b in zip(got, ref):
            _equal(a, b)


def test_run_benchmark_precomputed_posekit_equals_jax():
    """The eval harness on posekit, the default of both packages: the same
    AUCs from the same precomputed matches."""
    scenes = [_synth_scene(seed=s, outlier_frac=0.35) for s in (20, 21, 22)]
    pairs = []
    for _, _, K, R, t in scenes:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        pairs.append({"K0": K.tolist(), "K1": K.tolist(),
                      "T_0to1": T.tolist()})
    matches = [(s[0], s[1]) for s in scenes]
    ref = jax_md.run_benchmark_precomputed(matches, pairs)
    got = md.run_benchmark_precomputed(matches, pairs)
    assert got == md.run_benchmark_precomputed(matches, pairs,
                                               pose_backend="posekit")
    assert got == ref and got["n_pairs"] == 3 and got["acc@5"] == 1.0


def test_posekit_builds_into_the_port_and_raises_the_compiler_output(
        tmp_path, monkeypatch):
    assert pose.posekit_available()
    assert get_pose_estimator("posekit") is pose.estimate_relative_pose
    path = pose.library_path()
    assert path.parent == PKG / "_build" and path.exists()
    broken = tmp_path / "posekit.cpp"
    broken.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(pose, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="posekit build failed"):
        pose._build(tmp_path / "libposekit-broken.so")
    assert not list(tmp_path.glob("*.so"))
