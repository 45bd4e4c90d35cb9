"""The port's MegaDepth path on the CPU against the JAX package, on the
committed fixture `tests/fixtures/megadepth_mini` (two rendered scenes,
one JPEG with gzip-chunked depth, one color PNG with contiguous depth).

- `MegaDepthDataset` items, `collate`, `MegaDepthLoader` batches and
  `load_all_views` equal JAX's under `np.array_equal` (JAX reads through
  cv2 and h5py, the port through `utils/imageio` and `utils/hdf5`);
- `make_camera_pair` and `pair_overlap` equal JAX's;
- the resident and streamed batchers equal JAX's given JAX's draws, with
  the tolerances of `tests/test_torch_train_warp_aug.py`: correspondence
  rows kept by one side only are <= 3% of a pair's, and the rows both
  keep agree within 1e-3 px;
- `train.run.main --megadepth_root_path` takes 2 steps, resident and
  streamed, with h5py and cv2 unimportable; an exception in the prefetch
  thread surfaces in `main`, and the thread ends."""

import shutil
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from accelerated_features_tpu.train import megadepth as jmd
from accelerated_features_tpu.train import render as jrender
from accelerated_features_tpu.train import run as jrun
from accelerated_features_tpu_torch.train import megadepth as tmd
from accelerated_features_tpu_torch.train import render as trender
from accelerated_features_tpu_torch.train import run as trun

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "megadepth_mini"
SCENES = sorted((FIXTURE / "train_data").rglob("*.npz"))
RES = (128, 96)   # (W, H) of the training images here


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_fixture_layout():
    assert [p.name for p in SCENES] == ["scene_0000.npz", "scene_0001.npz"]
    imgs = sorted(p.name for p in (FIXTURE / "MegaDepth_v1").rglob("view_*")
                  if p.suffix in (".jpg", ".png"))
    assert imgs == ["view_0.jpg", "view_0.png", "view_1.jpg", "view_1.png",
                    "view_2.jpg", "view_2.png"]
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 4_000_000


@pytest.mark.parametrize("npz", SCENES, ids=lambda p: p.stem)
def test_dataset_items_equal_jax(npz):
    jd = jmd.MegaDepthDataset(str(FIXTURE / "MegaDepth_v1"), str(npz), RES)
    td = tmd.MegaDepthDataset(str(FIXTURE / "MegaDepth_v1"), str(npz), RES)
    assert jd.pairs == td.pairs and len(td) == 3
    items = []
    for i in range(len(td)):
        _same(jd[i], td[i])
        items.append(td[i])
    _same(jmd.collate(items), tmd.collate(items))
    assert items[0]["depth0"].shape == (2000, 2000)
    assert items[0]["scale0"].tolist() == [320 / 128, 240 / 96]


def test_loader_batches_equal_jax():
    jl = jmd.MegaDepthLoader(str(FIXTURE), 4, RES, seed=3)
    tl = tmd.MegaDepthLoader(str(FIXTURE), 4, RES, seed=3)
    n = 0
    for a, b in zip(jl, tl):
        _same(a, b)
        n += 1
    assert n == 1   # 6 pairs, batches of 4


def test_load_all_views_equals_jax():
    a = jmd.load_all_views(str(FIXTURE), RES)
    b = tmd.load_all_views(str(FIXTURE), RES)
    _same(a, b)
    assert b["images"].shape == (6, 96, 128, 1)
    assert b["depths"].shape == (6, 240, 320)


def test_depth_and_image_reads(monkeypatch):
    h5 = next((FIXTURE / "MegaDepth_v1").rglob("view_1.h5"))
    ref = np.load(h5.with_suffix(".npy"))
    assert np.array_equal(tmd.load_depth_h5(str(h5)), ref)
    assert tmd.load_depth_h5(str(h5) + ".missing") is None
    assert jmd.load_depth_h5(str(h5) + ".missing") is None
    png = next((FIXTURE / "MegaDepth_v1").rglob("view_2.png"))
    assert np.array_equal(tmd.imread_gray(str(png)),
                          jmd.imread_gray(str(png)))
    # s3:// paths go through read_bytes; without boto3 it raises, as JAX's
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(RuntimeError, match="boto3"):
        tmd.read_bytes("s3://bucket/key")
    with pytest.raises(RuntimeError, match="boto3"):
        jmd.read_bytes("s3://bucket/key")

    class Client:
        def get(self, path):
            return {"s3://b/d.h5": h5, "s3://b/i.png": png}[path] \
                .read_bytes()
    assert np.array_equal(tmd.load_depth_h5("s3://b/d.h5", Client()), ref)
    assert np.array_equal(tmd.imread_gray("s3://b/i.png", Client()),
                          jmd.imread_gray(str(png)))
    assert tmd.fix_path_from_d2net("a/Undistorted_SfM/b.jpg") == \
        jmd.fix_path_from_d2net("a/Undistorted_SfM/b.jpg")


def test_camera_pair_and_overlap_equal_jax():
    for seed in range(3):
        centre = np.array([0.3, -0.2, 5.0]) * (seed + 1)
        ja = jrender.make_camera_pair(np.random.default_rng(seed), centre)
        ta = trender.make_camera_pair(np.random.default_rng(seed), centre)
        for a, b in zip(ja, ta):
            assert np.array_equal(a, b)
    npz = np.load(SCENES[0], allow_pickle=True)
    depths = [np.load(p) for p in sorted(
        (FIXTURE / "MegaDepth_v1").rglob("scene_0000/depths/*.npy"))]
    K, P = npz["intrinsics"], npz["poses"]
    for (i, j), overlap, _ in npz["pair_infos"]:
        T = P[j] @ np.linalg.inv(P[i])
        a = jrender.pair_overlap(depths[i], depths[j], K[i], K[j], T)
        b = trender.pair_overlap(depths[i], depths[j], K[i], K[j], T)
        assert a == b == overlap


def _jax_draws(key, b, n_corrs, n_full):
    """What JAX's batchers draw from one step's key: the priorities of
    corr_to_fixed, then spvs_full's jitter."""
    k1, k2 = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.uniform(k1, (b, n_corrs)))),
            torch.tensor(np.asarray(jax.random.uniform(
                k2, (b, n_full, 2), minval=0.0, maxval=8.0))))


def _close_batches(j, t):
    """JAX's and the port's batch: images equal; per pair, the packed
    correspondence rows share >= 97% and agree within 1e-3 px."""
    j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: v.numpy() for k, v in t.items()}
    np.testing.assert_allclose(t["image0"], j["image0"], atol=1e-7)
    np.testing.assert_allclose(t["image1"], j["image1"], atol=1e-7)
    for c, m in (("corrs", "corr_valid"), ("corrs_full", "corr_full_valid")):
        for i in range(len(j[m])):
            a = {tuple(np.round(r, 2)) for r in j[c][i][j[m][i]]}
            b = {tuple(np.round(r, 2)) for r in t[c][i][t[m][i]]}
            assert len(a) > 30
            assert len(a ^ b) <= 0.03 * len(a), (c, i, len(a ^ b))
            both = j[m][i] & t[m][i]
            np.testing.assert_allclose(t[c][i][both], j[c][i][both],
                                       atol=1e-3)


def test_resident_batcher_equals_jax():
    jb = jrun.ResidentMegaDepthBatcher(str(FIXTURE), 3, RES, 256)
    tb = trun.ResidentMegaDepthBatcher(str(FIXTURE), 3, RES, 256,
                                       torch.device("cpu"))
    assert tb.views["depths"].dtype == torch.bfloat16
    key = jax.random.key(2)
    for _ in range(2):
        jbatch = jb.next()
        key, sub = jax.random.split(key)
        idx = torch.from_numpy(tb.rng.integers(0, tb.n_pairs, 3))
        prio, jit = _jax_draws(sub, 3, 12 * 16, 12 * 16)
        tbatch = trun.depth_ground_truth(tb.pairs(idx), 256, None, prio, jit)
        _close_batches(jbatch, tbatch)


def test_streamed_batcher_equals_jax():
    jb = jrun.MegaDepthBatcher(jmd.MegaDepthLoader(str(FIXTURE), 3, RES),
                               256)
    tl = tmd.MegaDepthLoader(str(FIXTURE), 3, RES).infinite()
    tb = trun.MegaDepthBatcher(tmd.MegaDepthLoader(str(FIXTURE), 3, RES),
                               256, torch.device("cpu"))
    key = jax.random.key(1)
    for _ in range(2):
        jbatch = jb.next()
        key, sub = jax.random.split(key)
        prio, jit = _jax_draws(sub, 3, 12 * 16, 12 * 16)
        tbatch = trun.depth_ground_truth(tb.pairs(next(tl)), 256, None,
                                         prio, jit)
        _close_batches(jbatch, tbatch)


def _args(ck, extra=()):
    return ["--ckpt_save_path", str(ck), "--megadepth_root_path",
            str(FIXTURE), "--training_type", "xfeat_megadepth",
            "--batch_size", "2", "--n_steps", "2", "--training_res",
            f"{RES[0]},{RES[1]}", "--max_corrs", "64", "--device", "cpu",
            "--save_ckpt_every", "2", *extra]


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "streamed"])
def test_run_main_trains_on_the_fixture(tmp_path, monkeypatch, resident):
    """Two steps with neither h5py nor cv2 importable."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    history = trun.main(_args(tmp_path / "ck",
                              ["--md_resident"] if resident else []))
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss_total"]) for h in history)
    assert (tmp_path / "ck" / "ckpt_00000002.npz").exists()
    assert not [t for t in threading.enumerate()
                if t.name == "batch-prefetch"]


def test_prefetch_error_surfaces_in_main(tmp_path):
    root = tmp_path / "md"
    shutil.copytree(FIXTURE, root)
    for h5 in root.rglob("*.h5"):
        h5.write_bytes(b"\0" * 64)        # unreadable depth everywhere
    args = _args(tmp_path / "ck")
    args[args.index(str(FIXTURE))] = str(root)
    with pytest.raises(ValueError, match="HDF5"):
        trun.main(args)
    assert not [t for t in threading.enumerate()
                if t.name == "batch-prefetch"]


def test_prefetcher_order_errors_and_stop():
    calls = iter(range(100))

    def fn():
        i = next(calls)
        if i == 3:
            raise KeyError("third")
        return {"i": torch.tensor(i)}
    pf = trun.Prefetcher(fn, torch.device("cpu"))
    assert [int(pf()["i"]) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="third"):
        pf()
    pf.stop()
    assert not pf._thread.is_alive()
    pf = trun.Prefetcher(lambda: {"x": torch.zeros(1)}, torch.device("cpu"))
    pf()
    pf.stop()   # the producer blocks on a full queue; stop still ends it
    assert not pf._thread.is_alive()
    while not pf._queue.empty():
        pf._queue.get()
    with pytest.raises(RuntimeError, match="ended without a batch"):
        pf()    # a dead producer never leaves the consumer waiting


def test_import_without_h5py_or_cv2():
    import subprocess
    code = ("import sys; sys.modules['h5py'] = None; "
            "sys.modules['cv2'] = None; "
            "import accelerated_features_tpu_torch.train.megadepth as m; "
            "import accelerated_features_tpu_torch.train.run")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parents[1], timeout=120)
