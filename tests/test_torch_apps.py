"""The port's command-line apps and examples (`accelerated_features_tpu_
torch/apps/`, `examples/torch_*.py`) against the JAX package's root
`apps/`, on the CPU, at small sizes.

- `gt_homography` and `corner_error` equal JAX's under np.array_equal.
- `eval_synthetic` on two holdout crops, 4 pairs, top_k 512, the trained
  extractor loaded by both, against `apps/eval_synthetic.py --platform
  cpu` run in this process: `homography_success` equal; `mean_matches`
  within 2% and `precision@3px` within 0.02 (real-image scores differ by
  up to 3e-4 between the packages, which moves a few keypoints near the
  threshold or the top-k boundary, `tests/test_torch_pipeline.py`);
  `mace_median_px` within 0.5 px and each `h_auc@*` within 0.05 (four
  pairs: one pair's corner error moving by a fraction of a pixel moves
  an AUC by up to 1/4 of that fraction over its threshold).
- `sfm_pipeline` and `slam_demo` with both packages' `XFeat` replaced by
  one stub that returns the same injected features and matches (no JAX
  file changes; monkeypatch only): the SfM cameras and points within
  1e-3 of their largest value and the BA's final cost within 1e-4
  relative (float32 pose graphs and BAs summed in another order,
  `tests/test_torch_sfm.py`'s gates); the SLAM keyframes equal and the
  trajectories within 1e-2 of their extent after a similarity alignment
  (`test_torch_sfm.py::_same_run`). A non-image file among the frames is
  skipped with cv2 unimportable.
- `sfm_pipeline --sharded` on two gloo ranks on the CPU against the
  single-device solve, at `tests/test_torch_parallel.py`'s BA
  tolerances (final cost within 1e-5 relative, cameras and points within
  2e-3 + 1e-3 relative).
- `register_demo`'s homography and inliers on injected matches equal to
  JAX's (both are posekit, built from one source); its drawing written by
  `write_png` reads back equal; ORB without cv2 exits naming cv2.
- `profile_extraction` at B = 1, 64x64: every stage row present, and its
  backbone FLOP count equal to a count of the convolutions the backbone
  actually runs.
- `minimal_example` and each `examples/torch_*.py` of this slice exit 0
  with `--device cpu`.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch import sfm
from accelerated_features_tpu_torch.apps import (eval_synthetic,
                                                 profile_extraction,
                                                 register_demo,
                                                 sfm_pipeline, slam_demo)
from accelerated_features_tpu_torch.utils.imageio import (read_frames,
                                                          read_png,
                                                          write_png)
from accelerated_features_tpu_torch.utils.text import put_text

from torch_support import CKPT, HOLDOUT, ROOT

FX, FW, FH = 500.0, 640, 480
K_APP = np.array([[FX, 0, FW / 2], [0, FX, FH / 2], [0, 0, 1]])


# ---------------------------------------------------- eval_synthetic

def test_gt_homography_and_corner_error_equal_jax():
    import apps.eval_synthetic as jes
    r0, r1 = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(10):
        w, h = 800 - 16 * i, 608 - 8 * i
        H = eval_synthetic.gt_homography(r0, w, h, 0.25 + 0.5 * i)
        assert np.array_equal(H, jes.gt_homography(r1, w, h, 0.25 + 0.5 * i))
        H2 = eval_synthetic.gt_homography(r0, w, h)
        assert np.array_equal(H2, jes.gt_homography(r1, w, h))
        assert eval_synthetic.corner_error(H, H2, w, h) == \
            jes.corner_error(H, H2, w, h)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """Two 320x224 crops of holdout PNGs, flat, as the benchmark globs."""
    d = tmp_path_factory.mktemp("synth")
    pngs = sorted(HOLDOUT.rglob("*.png"))
    for i, p in enumerate((pngs[0], pngs[13])):
        write_png(d / f"crop_{i}.png", read_png(p)[100:324, 200:520])
    return d


def test_eval_synthetic_matches_jax(synth_dir, tmp_path, monkeypatch):
    import apps.eval_synthetic as jes
    args = ["--images", str(synth_dir), "--ckpt", CKPT, "--pairs", "4",
            "--top_k", "512"]
    monkeypatch.setattr(sys, "argv", ["eval_synthetic", *args, "--platform",
                                      "cpu", "--json",
                                      str(tmp_path / "jax.json")])
    jes.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    got = eval_synthetic.main([*args, "--device", "cpu", "--json",
                               str(tmp_path / "port.json")])[0]
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got["device"] == "cpu" and got["pairs"] == 4
    assert got["homography_success"] == want["homography_success"]
    assert got["homography_success"] >= 0.75
    assert got["mean_matches"] == pytest.approx(want["mean_matches"],
                                                rel=0.02)
    assert abs(got["precision@3px"] - want["precision@3px"]) <= 0.02
    assert abs(got["mace_median_px"] - want["mace_median_px"]) <= 0.5
    for t in (3, 5, 10):
        assert abs(got[f"h_auc@{t}px"] - want[f"h_auc@{t}px"]) <= 0.05


# --------------------------------------------------------- the stub

def _scene(n_frames=6, seed=0, noise=0.3, step=0.3, n_pts=1500):
    """Features of a 640x480 camera moving `step` a frame along x past
    `n_pts` points: per frame the keypoints (float32, with `noise` px of
    Gaussian noise), scores and unit descriptors of the visible points;
    and the world-to-camera poses."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-5, -3, 6], [5 + step * n_frames, 3, 14], (n_pts, 3))
    desc = rng.normal(size=(n_pts, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    feats, poses = [], []
    for i in range(n_frames):
        pose = np.array([0, 0.02 * i, 0, -step * i, 0.02 * i, 0],
                        np.float32)
        uv = sfm.project(torch.from_numpy(pose),
                         torch.from_numpy(X.astype(np.float32)),
                         torch.from_numpy(K_APP.astype(np.float32))).numpy()
        ids = np.nonzero((uv[:, 0] > 0) & (uv[:, 0] < FW) & (uv[:, 1] > 0)
                         & (uv[:, 1] < FH))[0]
        kp = uv[ids] + rng.normal(0, noise, (len(ids), 2))
        feats.append({"keypoints": kp.astype(np.float32),
                      "scores": np.ones(len(ids), np.float32),
                      "descriptors": desc[ids]})
        poses.append(pose)
    return feats, np.stack(poses)


def _write_frames(d: Path, n: int, extras=True):
    """n constant 640x480 frames (frame i holds the value 10 i, which the
    stub reads as its index), with a gt.npy and a README beside them."""
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_png(d / f"frame_{i:03d}.png", np.full((FH, FW, 3), 10 * i,
                                                    np.uint8))
    if extras:
        (d / "README").write_text("frames of a synthetic scene")
    return d


class _StubXFeat:
    """Both packages' `XFeat` for the apps: `detectAndCompute` returns the
    injected features of frame 10 i's index i, `match` the mutual
    nearest neighbours of the descriptors (exact for injected unit
    descriptors of one point cloud). `FEATS` is set by the test; the JAX
    subclass returns numpy, the port's torch tensors, as each package's
    `XFeat` does."""
    FEATS = None

    def __init__(self, *args, **kwargs):
        self.device = torch.device("cpu")

    def _out(self, x):
        return x

    def detectAndCompute(self, image, *args, **kwargs):
        f = self.FEATS[int(np.asarray(image)[0, 0, 0]) // 10]
        return [{k: self._out(v) for k, v in f.items()}]

    def match(self, d0, d1, min_cossim=0.82):
        d0, d1 = (np.asarray(torch.as_tensor(d)) for d in (d0, d1))
        sim = d0 @ d1.T
        j = sim.argmax(1)
        i0 = np.nonzero(sim.argmax(0)[j] == np.arange(len(d0)))[0]
        return self._out(i0), self._out(j[i0])

    def match_xfeat(self, im0, im1):
        f0, f1 = (self.FEATS[int(im[0, 0, 0]) // 10] for im in (im0, im1))
        i0, i1 = (np.asarray(i) for i in self.match(f0["descriptors"],
                                                    f1["descriptors"]))
        return f0["keypoints"][i0], f1["keypoints"][i1]


class _StubPort(_StubXFeat):
    def _out(self, x):
        return torch.as_tensor(x)


def _run_jax_app(module, args, cwd, monkeypatch, feats):
    import accelerated_features_tpu as jpkg
    monkeypatch.setattr(jpkg, "XFeat", type("_J", (_StubXFeat,),
                                            {"FEATS": feats}))
    monkeypatch.setattr(sys, "argv", [module.__name__, *args])
    monkeypatch.chdir(cwd)
    module.main()


def _run_port_app(module, args, cwd, monkeypatch, feats):
    monkeypatch.setattr(module, "XFeat", type("_P", (_StubPort,),
                                              {"FEATS": feats}))
    monkeypatch.chdir(cwd)
    return module.main([*args, "--device", "cpu"])


# ----------------------------------------------------------- sfm_pipeline

@pytest.fixture(scope="module")
def sfm_scene(tmp_path_factory):
    feats, poses = _scene()
    d = _write_frames(tmp_path_factory.mktemp("sfm") / "frames", len(feats))
    np.save(d / "gt.npy", poses)
    return feats, poses, d


def test_sfm_pipeline_matches_jax(sfm_scene, tmp_path, monkeypatch):
    import apps.sfm_pipeline as jsfm
    feats, poses, frames = sfm_scene
    args = ["--images", str(frames), "--fx", str(FX), "--gt_poses",
            str(frames / "gt.npy")]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _run_jax_app(jsfm, args, tmp_path / "jax", monkeypatch, feats)
    got = _run_port_app(sfm_pipeline, args, tmp_path / "port", monkeypatch,
                        feats)
    want = {k: np.load(tmp_path / "jax" / f"sfm_{k}.npy")
            for k in ("poses", "points")}
    for k in ("poses", "points"):
        saved = np.load(tmp_path / "port" / f"sfm_{k}.npy")
        assert np.array_equal(saved, got[k])
        assert saved.shape == want[k].shape
        scale = np.abs(want[k]).max()
        assert np.abs(saved - want[k]).max() <= 1e-3 * scale, k
    assert got["rmse_after"] < got["rmse_before"]
    assert got["ate"] < 0.05
    assert len(got["poses"]) == len(feats)


def test_sfm_pipeline_skips_non_images_without_cv2(sfm_scene, tmp_path,
                                                    monkeypatch):
    feats, _, frames = sfm_scene
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert [i for i, _ in read_frames(frames, 50)] == list(
        range(1, len(feats) + 1))   # the README sorts first
    got = _run_port_app(sfm_pipeline, ["--images", str(frames), "--fx",
                                       str(FX), "--ba_iters", "3"],
                        tmp_path, monkeypatch, feats)
    assert got["poses"].shape == (len(feats), 6)
    assert (tmp_path / "sfm_points.npy").exists()


def _sharded_rank(rank, feats, frames, out_dir):
    """One gloo rank of `sfm_pipeline --sharded` with the stub."""
    sfm_pipeline.XFeat = type("_P", (_StubPort,), {"FEATS": feats})
    os.chdir(out_dir)
    got = sfm_pipeline.main(["--images", frames, "--fx", str(FX),
                             "--sharded", "--device", "cpu"])
    return {k: got[k] for k in ("poses", "points", "final_cost")}


def test_sfm_pipeline_sharded_on_two_ranks_matches_one(sfm_scene, tmp_path,
                                                       monkeypatch):
    from accelerated_features_tpu_torch.parallel.dryrun import run_ranks
    feats, _, frames = sfm_scene
    res = run_ranks(_sharded_rank, 2, feats, str(frames), str(tmp_path),
                    device="cpu", timeout=240.0)
    (tmp_path / "one").mkdir()
    single = _run_port_app(sfm_pipeline, ["--images", str(frames), "--fx",
                                          str(FX)], tmp_path / "one",
                           monkeypatch, feats)
    assert np.array_equal(np.load(tmp_path / "sfm_poses.npy"),
                          res[0]["poses"])
    for r in res:
        assert r["final_cost"] == pytest.approx(single["final_cost"],
                                                rel=1e-5)
        np.testing.assert_allclose(r["poses"], single["poses"], atol=2e-3,
                                   rtol=1e-3)
        np.testing.assert_allclose(r["points"], single["points"], atol=2e-3,
                                   rtol=1e-3)


# ------------------------------------------------------------- slam_demo

def test_slam_demo_matches_jax(tmp_path, monkeypatch):
    import apps.slam_demo as jslam
    feats, poses = _scene(n_frames=16, seed=1, step=2.0)
    frames = _write_frames(tmp_path / "frames", len(feats))
    np.save(frames / "gt.npy", poses)
    args = ["--images", str(frames), "--fx", str(FX), "--gt_poses",
            str(frames / "gt.npy"), "--window", "4"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _run_jax_app(jslam, args, tmp_path / "jax", monkeypatch, feats)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = _run_port_app(slam_demo, args, tmp_path / "port", monkeypatch,
                        feats)
    want = np.load(tmp_path / "jax" / "slam_trajectory.npy")
    traj = np.load(tmp_path / "port" / "slam_trajectory.npy")
    assert np.array_equal(traj, got["trajectory"])
    assert traj.shape == want.shape and len(traj) >= 4
    gap = sfm.absolute_trajectory_error(traj, want)
    R = sfm.so3_exp(torch.as_tensor(want[:, :3])).numpy()
    centers = np.stack([-R[i].T @ want[i, 3:] for i in range(len(want))])
    assert gap <= 1e-2 * np.linalg.norm(np.ptp(centers, axis=0))
    assert got["ate"] < 0.1


# ----------------------------------------------------------- register_demo

def test_register_homography_equals_jax():
    import apps.register_demo as jreg
    rng = np.random.default_rng(2)
    p0 = rng.uniform(0, 640, (400, 2))
    H = np.array([[0.9, 0.05, 20], [-0.04, 1.1, 10], [1e-4, -5e-5, 1.0]])
    ph = np.concatenate([p0, np.ones((400, 1))], 1) @ H.T
    p1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 0.5, (400, 2))
    p1[:80] = rng.uniform(0, 640, (80, 2))      # outliers
    im = np.zeros((8, 8, 3), np.uint8)
    got = register_demo.register(lambda a, b: (p0, p1), im, im)
    want = jreg.register(lambda a, b: (p0, p1), im, im)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[3], want[3]) and got[3].sum() >= 300
    few = register_demo.register(lambda a, b: (p0[:40], p1[:40]), im, im)
    assert few[0] is None and not few[3].any()


def test_register_demo_draws_and_writes_without_cv2(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(4)
    im0 = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    im1 = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    p0 = rng.uniform(0, 127, (30, 2))
    H = np.array([[1.0, 0.1, 5], [0.0, 0.9, 3], [0, 0, 1.0]])
    inl = np.arange(30) % 3 != 0
    vis = register_demo.draw(im0, im1, H, p0, p0 + 2, inl)
    assert vis.shape == (96, 256, 3)
    # the label is drawn onto the image (utils/text), not printed
    assert "inliers" not in capsys.readouterr().out
    label = np.zeros((96, 256), np.uint8)
    put_text(label, "inliers: 20", (10, 30), 0, 1, 255, 2)
    assert label.sum() > 255 * 100
    assert (vis[label == 255] == 255).all()
    assert (vis == (0, 0, 255)).all(-1).sum() > 300       # the outline
    assert (vis == (0, 255, 0)).all(-1).sum() >= 20 * 3   # the lines
    write_png(tmp_path / "vis.png", vis)
    assert np.array_equal(read_png(tmp_path / "vis.png"), vis)
    with pytest.raises(SystemExit, match="cv2"):
        register_demo.main(["--method", "ORB", "--ref", "a", "--tgt", "b"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_demo_draw_equals_jax(seed):
    """The matches and the outline equal the JAX app's cv2 drawing pixel
    for pixel; the label (cv2 5.0.0's text) is within the text tolerance
    of tests/test_torch_text.py: at most 8 levels, 2 % of its pixels."""
    import cv2
    import apps.register_demo as jreg
    rng = np.random.default_rng(seed)
    im0 = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    im1 = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    p0 = rng.uniform(-5, 165, (60, 2))
    p1 = rng.uniform(-5, 165, (60, 2))
    inl = rng.random(60) < 0.6
    H = np.array([[1.0 + 0.2 * rng.random(), 0.1 * rng.random(), 40.0],
                  [-0.05, 0.9, 10 * rng.random() - 20],
                  [2e-4 * rng.random(), 1e-4, 1.0]])
    want = jreg.draw(im0, im1, H, p0, p1, inl, fps=12.34)
    got = register_demo.draw(im0, im1, H, p0, p1, inl, fps=12.34)
    label = np.zeros(want.shape[:2], np.uint8)
    cv2.putText(label, f"inliers: {int(inl.sum())}  fps: 12.3", (10, 30),
                cv2.FONT_HERSHEY_SIMPLEX, 1, 255, 2)
    d = np.abs(want.astype(np.int64) - got).max(-1)
    assert not d[label == 0].any()
    assert d.max() <= 8 and (d > 0).sum() <= 0.02 * (label > 0).sum()


def test_register_demo_main_writes_what_it_drew(tmp_path, monkeypatch):
    frames = _write_frames(tmp_path, 2, extras=False)
    feats, _ = _scene(n_frames=2, seed=3, noise=0.0)
    monkeypatch.setattr(register_demo, "XFeat", type(
        "_P", (_StubPort,), {"FEATS": feats}))
    out = tmp_path / "reg.png"
    got = register_demo.main(["--ref", str(frames / "frame_000.png"),
                              "--tgt", str(frames / "frame_001.png"),
                              "--out", str(out), "--device", "cpu"])
    assert got["H"] is not None and got["n_inliers"] >= 50
    assert np.array_equal(read_png(out), got["image"])


# ------------------------------------------------------ profile_extraction

def test_profile_extraction_rows_and_flop_count(monkeypatch):
    rows = profile_extraction.main(["--batch", "1", "--res", "64x64",
                                    "--top_k", "64", "--dtype", "float32",
                                    "--fused_stem", "--device", "cpu"])
    names = [r["stage"] for r in rows]
    for part in ("input_norm", "block1.conv1", "block1.conv4",
                 "stem total (IN+block1+skip", "stem total (plain)",
                 "backbone total", "nms+score+topk (plain)",
                 "heatmap_decode", "bicubic sample+norm (plain)",
                 "FULL detect_and_compute"):
        assert any(n.startswith(part) for n in names), part
    assert all(r["ms"] > 0 and r["device"] == "cpu" for r in rows)
    assert all(r["sol_ms"] is not None for r in rows
               if not r["stage"].startswith("block1.conv"))

    # every conv the backbone runs, counted where it runs
    import torch.nn.functional as F
    from accelerated_features_tpu_torch.models import backbone
    from accelerated_features_tpu_torch.models.params import load_params
    flops = []
    conv = F.conv2d

    def counted(x, w, *args, **kwargs):
        y = conv(x, w, *args, **kwargs)
        flops.append(2.0 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        return y
    monkeypatch.setattr(backbone.F, "conv2d", counted)
    params = load_params(None)
    x = torch.rand((2, 96, 128, 3))
    backbone.xfeat_forward(params, x)
    costs = profile_extraction.stage_costs(params, 2, 96, 128, 64, 4)
    assert costs["backbone"][0] == sum(flops)
    assert len(flops) == 1 + sum(len(params[k]) for k in (
        "block1", "block2", "block3", "block4", "block5", "block_fusion",
        "heatmap_head", "keypoint_head"))


# ----------------------------------------------- minimal_example, examples

@pytest.mark.parametrize("cmd", [
    ["-m", "accelerated_features_tpu_torch.apps.minimal_example", "--res",
     "128x96"],
    ["examples/torch_01_matching.py"],
    ["examples/torch_02_homography.py", "--out", "{tmp}/warped.png"],
    ["examples/torch_05_lighterglue.py"],
    ["examples/torch_09_slam_ate.py", "--frames", "5", "--res", "160x120"],
], ids=["minimal_example", "torch_01", "torch_02", "torch_05", "torch_09"])
def test_app_and_example_run_on_cpu(cmd, tmp_path):
    cmd = [c.replace("{tmp}", str(tmp_path)) for c in cmd]
    run = subprocess.run([sys.executable, *cmd, "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "cpu" in run.stdout
    if "torch_02" in cmd[0]:
        assert read_png(tmp_path / "warped.png").shape == (608, 800, 3)
