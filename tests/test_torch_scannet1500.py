"""The port's ScanNet-1500 harness (`eval/scannet1500.py`) against the JAX
package's, on the CPU.

Function by function on the same inputs; the whole benchmark on a rendered
ScanNet-layout fixture with ground-truth matches from its exact depth
(AUC equal to JAX's), and through both CLIs; the batched matches of the
committed 640x480 fixture with the trained extractor, equal as sets to
JAX's and to the port's per-pair path; and the posekit pool (`workers=2`)
equal to one process under `np.array_equal`."""

import json
import os
import sys

import cv2
import numpy as np
import pytest

from accelerated_features_tpu.eval import scannet1500 as jsn
from accelerated_features_tpu_torch.eval import scannet1500 as sn

from torch_support import CKPT, SCANNET_MINI

NPZ = str(SCANNET_MINI / "test.npz")


def _pair_set(mk0, mk1):
    return {tuple(r) for r in np.concatenate(
        [np.asarray(mk0, np.float64), np.asarray(mk1, np.float64)],
        1).tolist()}


def test_pair_list_poses_and_ground_truth_equal_jax():
    pairs = sn.load_pair_list(NPZ)
    assert pairs == jsn.load_pair_list(NPZ) and len(pairs) == 6
    gt = sn.load_ground_truth(str(SCANNET_MINI), pairs)
    for pair, g in zip(pairs, gt):
        p0 = sn.read_pose(str(SCANNET_MINI / pair["pose0"]))
        p1 = sn.read_pose(str(SCANNET_MINI / pair["pose1"]))
        assert np.array_equal(
            p0, jsn.read_pose(str(SCANNET_MINI / pair["pose0"])))
        T = sn.rel_pose_0to1(p0, p1)
        assert np.array_equal(T, jsn.rel_pose_0to1(p0, p1))
        assert np.array_equal(g["T_0to1"], T)
        K = np.loadtxt(str(SCANNET_MINI / pair["intrinsic"]))[:3, :3]
        assert np.array_equal(g["K"], K)
    assert sn.THRESHOLDS == jsn.THRESHOLDS


def test_match_cache_is_shared_with_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    matches = [(rng.uniform(0, 640, (n, 2)).astype(np.float32),
                rng.uniform(0, 480, (n, 2)).astype(np.float32))
               for n in (5, 5, 0, 17)]
    port, jx = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    sn._write_match_cache(port, matches, "meta A")
    jsn._write_match_cache(jx, matches, "meta A")
    for path in (port, jx):
        for read in (sn._read_match_cache, jsn._read_match_cache):
            got = read(path, "meta A", 4)
            assert len(got) == 4 and all(
                np.array_equal(a, c) and np.array_equal(b, d)
                for (a, b), (c, d) in zip(got, matches))
            assert read(path, None, 4) is not None
            assert read(path, "meta B", 4) is None
            assert read(path, "meta A", 3) is None
    assert "different configuration" in capsys.readouterr().out
    assert sn._read_match_cache(str(tmp_path / "none.npz"), None, 4) is None


def _scene_matches(seed, n=300, noise=0.3):
    """Correspondences of a seeded two-view scene, with K and T_0to1."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    ang = rng.normal(0, 0.1, 3)
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 8, n)], -1)
    x0 = X @ K.T
    X1 = X @ R.T + t
    x1 = X1 @ K.T
    mk0 = x0[:, :2] / x0[:, 2:] + rng.normal(0, noise, (n, 2))
    mk1 = x1[:, :2] / x1[:, 2:] + rng.normal(0, noise, (n, 2))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return mk0, mk1, K, T


def test_pose_error_and_sweep_equal_jax(tmp_path):
    """posekit is the same source with the same flags in both packages, so
    each pair's error and the whole sweep are equal; fewer than 5 matches
    is 180 degrees."""
    scenes = [_scene_matches(s, noise=0.3 + 0.5 * s) for s in range(4)]
    matches = [(m0, m1) for m0, m1, _, _ in scenes]
    matches.append((matches[0][0][:4], matches[0][1][:4]))
    gt = [{"K": K, "T_0to1": T} for _, _, K, T in scenes] + \
        [{"K": scenes[0][2], "T_0to1": scenes[0][3]}]
    for (m0, m1), g in zip(matches, gt):
        for thr in (0.5, 2.0):
            args = (m0, m1, g["K"], g["T_0to1"], thr, "posekit")
            assert sn._pose_error_one(args) == jsn._pose_error_one(args)
    assert sn._pose_error_one(
        (matches[-1][0], matches[-1][1], gt[0]["K"], gt[0]["T_0to1"], 1.0,
         "posekit")) == 180.0
    thresholds = [0.5, 1.5, 3.0]
    ref = jsn.run_threshold_sweep(matches, gt, thresholds)
    got = sn.run_threshold_sweep(matches, gt, thresholds)
    assert got == ref
    cached = sn.run_threshold_sweep(matches, gt, thresholds,
                                    cache_dir=str(tmp_path / "c"))
    assert cached == ref and len(os.listdir(tmp_path / "c")) == 3
    assert sn.run_threshold_sweep(matches, gt, thresholds,
                                  cache_dir=str(tmp_path / "c")) == ref
    assert sn.best_result(got) == jsn.best_result(ref)
    on_dev = sn.run_threshold_sweep(matches, gt, thresholds,
                                    pose_backend="gpu", device="cpu")
    assert on_dev.keys() == ref.keys()
    with pytest.raises(ValueError, match="workers <= 1"):
        sn.run_threshold_sweep(matches, gt, thresholds, workers=2,
                               pose_backend="gpu", device="cpu")


def test_sweep_pool_equals_one_process():
    """`workers=2` (a spawn pool, each process loading posekit itself)
    gives every threshold's summary of `workers=0`, value for value."""
    scenes = [_scene_matches(10 + s, noise=1.0) for s in range(6)]
    matches = [(m0, m1) for m0, m1, _, _ in scenes]
    gt = [{"K": K, "T_0to1": T} for _, _, K, T in scenes]
    one = sn.run_threshold_sweep(matches, gt, sn.THRESHOLDS[:4], workers=0)
    pool = sn.run_threshold_sweep(matches, gt, sn.THRESHOLDS[:4], workers=2)
    assert one.keys() == pool.keys()
    for k in one:
        keys = sorted(one[k])
        assert np.array_equal([one[k][m] for m in keys],
                              [pool[k][m] for m in keys])


def test_best_result_and_report_equal_jax(tmp_path):
    sweep = {f"thr_{t}": {"auc@5": a, "auc@10": b, "auc@20": c,
                          "acc@5": a, "acc@10": b, "acc@20": c, "n_pairs": 3}
             for t, a, b, c in ((0.5, 0.1, 0.2, 0.3), (1.0, 0.3, 0.2, 0.4),
                                (1.5, 0.2, 0.3, 0.45))}
    best = sn.best_result(sweep)
    assert best == jsn.best_result(sweep) and best["best_threshold"] == 1.5
    path = tmp_path / "run.json"
    path.write_text(json.dumps({"sweep": sweep, "best": best}))
    got, ref = sn.report([str(path)]), jsn.report([str(path)])
    assert got.equals(ref) and len(got) == 4


def _render_tmp_fixture(tmp_path):
    """A ScanNet-layout fixture at 240x180 with exact depth, rendered by
    the JAX package's renderer from seeded noise textures."""
    from apps.render_scannet_fixture import render_fixture
    tex = tmp_path / "tex"
    tex.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(str(tex / f"t{i}.png"),
                    rng.integers(0, 256, (128, 128, 3)).astype(np.uint8))
    root = str(tmp_path / "scannet")
    render_fixture(root, str(tex), scenes=2, views=3, w=240, h=180, seed=1)
    return root


def _gt_matcher(root, pairs):
    """Ground-truth matches from the rendered depth, pair by pair in list
    order (the warp of `tests/test_eval.py`'s protocol test)."""
    state = {"i": 0}

    def fn(im0, im1):
        pair = pairs[state["i"] % len(pairs)]
        state["i"] += 1
        sdir = os.path.join(root, pair["scene"])
        i0 = int(os.path.basename(pair["im0"]).split(".")[0])
        i1 = int(os.path.basename(pair["im1"]).split(".")[0])
        d0 = np.load(os.path.join(sdir, "depth", f"{i0}.npy"))
        d1 = np.load(os.path.join(sdir, "depth", f"{i1}.npy"))
        K = np.loadtxt(os.path.join(sdir, "intrinsic",
                                    "intrinsic_color.txt"))[:3, :3]
        T0 = np.linalg.inv(sn.read_pose(os.path.join(sdir, "pose",
                                                     f"{i0}.txt")))
        T1 = np.linalg.inv(sn.read_pose(os.path.join(sdir, "pose",
                                                     f"{i1}.txt")))
        T = T1 @ np.linalg.inv(T0)
        h, w = d0.shape
        ys, xs = np.mgrid[3:h:6, 3:w:6]
        d = d0[ys, xs]
        pts = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs, float)], -1)
        cam1 = ((pts @ np.linalg.inv(K).T) * d[..., None]) @ T[:3, :3].T \
            + T[:3, 3]
        proj = cam1 @ K.T
        uv = proj[..., :2] / np.maximum(proj[..., 2:], 1e-9)
        inb = (d > 0) & (cam1[..., 2] > 0) & (uv[..., 0] >= 0) \
            & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
        ui = np.clip(uv[..., 0].astype(int), 0, w - 1)
        vi = np.clip(uv[..., 1].astype(int), 0, h - 1)
        dz = d1[vi, ui]
        cons = inb & (dz > 0) & (np.abs(dz - cam1[..., 2])
                                 <= 0.03 * cam1[..., 2] + 0.02)
        return (pts[cons][:, :2].astype(np.float32),
                uv[cons].astype(np.float32))
    return fn


def test_full_benchmark_with_ground_truth_matches_equals_jax(tmp_path):
    """Pair list -> frames (JPEG, read without cv2 in the port) -> ground
    truth matches with the cache -> sweep -> best: AUC equal to JAX's and
    near 1; the cached rerun calls no matcher; the per-threshold error
    cache resumes; the saved sweep reports as JAX's does."""
    root = _render_tmp_fixture(tmp_path)
    npz = os.path.join(root, "test.npz")
    pairs = sn.load_pair_list(npz)
    kw = dict(cache_meta="gt fixture")
    ref = jsn.run_benchmark(_gt_matcher(root, pairs), root, npz,
                            summary_path=str(tmp_path / "jax.json"), **kw)
    cache = str(tmp_path / "cache.npz")
    got = sn.run_benchmark(_gt_matcher(root, pairs), root, npz,
                           cache_path=cache, cache_dir=str(tmp_path / "e"),
                           summary_path=str(tmp_path / "port.json"), **kw)
    assert got == ref and got["auc@10"] > 0.8

    def explode(*_a):
        raise AssertionError("the match cache was not used")
    again = sn.run_benchmark(explode, root, npz, cache_path=cache,
                             cache_dir=str(tmp_path / "e"), **kw)
    assert again == got
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert port_json == json.loads((tmp_path / "jax.json").read_text())
    # the run column is the file's name
    assert sn.report([str(tmp_path / "port.json")]).drop(columns="run") \
        .equals(jsn.report([str(tmp_path / "jax.json")]).drop(columns="run"))


def test_clis_give_the_same_summary(tmp_path, monkeypatch, capsys):
    """`python -m ...eval.scannet1500 --batched` of both packages on a
    rendered fixture, the trained extractor at top_k 256, posekit in one
    process: the same best summary."""
    root = _render_tmp_fixture(tmp_path)
    npz = os.path.join(root, "test.npz")
    common = ["--data_root", root, "--npz", npz, "--batched", "--top_k",
              "256", "--weights", CKPT, "--workers", "0"]
    sn.main(common + ["--device", "cpu", "--out", str(tmp_path / "p.json")])
    monkeypatch.setattr(sys, "argv", ["scannet1500"] + common
                        + ["--out", str(tmp_path / "j.json")])
    jsn.main()
    capsys.readouterr()
    got = json.loads((tmp_path / "p.json").read_text())
    ref = json.loads((tmp_path / "j.json").read_text())
    assert got["best"] == ref["best"] and got["sweep"] == ref["sweep"]
    assert got["best"]["n_pairs"] == 6


def test_batched_matches_equal_jax_and_per_pair():
    """The committed 640x480 fixture, the trained extractor at top_k 512:
    the port's batched matches equal JAX's batched matches as sets, and
    the port's per-pair `match_xfeat` path, for every pair."""
    from accelerated_features_tpu_torch.eval.megadepth1500 import \
        make_matcher
    pairs = sn.load_pair_list(NPZ)
    got = sn.extract_matches_batched(str(SCANNET_MINI), pairs, top_k=512,
                                     weights=CKPT, batch_size=4,
                                     progress=False, device="cpu")
    ref = jsn.extract_matches_batched(str(SCANNET_MINI), pairs, top_k=512,
                                      weights=CKPT, batch_size=4,
                                      progress=False)
    per_pair = sn.extract_matches(make_matcher("xfeat", 512, CKPT,
                                               device="cpu"),
                                  str(SCANNET_MINI), pairs, progress=False)
    assert len(got) == len(ref) == len(per_pair) == 6
    for (g0, g1), (r0, r1), (p0, p1) in zip(got, ref, per_pair):
        assert len(g0) > 50
        assert _pair_set(g0, g1) == _pair_set(r0, r1)
        assert _pair_set(g0, g1) == _pair_set(p0, p1)

