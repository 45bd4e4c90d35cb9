"""The port's data generators (`accelerated_features_tpu_torch/apps/
render_depth_dataset.py`, `render_scannet_fixture.py`,
`make_eval_variants.py`, `tools/make_megadepth_fixture.py`) against the
JAX package's root `apps/`, on the CPU.

The JAX apps run in this process with cv2 and h5py; the port's run in one
subprocess in which `cv2`, `h5py` and `jax` cannot be imported. Both start
from the same flat texture pool (holdout PNGs, one JPEG that cv2 wrote and
one `.png` file that is no image, which both skip) and the same seeds, at
96x72. The two trees must hold the same files, and:

- PNG pixels equal (cv2 reads both), JPEG bytes equal;
- every `.h5` read by h5py equal, with equal chunks, compression, its
  options and shuffle;
- every `.npz` index equal field by field, and the JSON manifests, the
  `test.npz`, the pose and intrinsic txt files and the `depth/*.npy`
  equal.

`make_eval_variants` at 640 and 1024 on the committed
`rendered_pose_pairs.json` equals the JAX app's output, and the fixture
tool, now writing with `write_jpeg`/`write_png`/`write_dataset`,
reproduces the committed `tests/fixtures/megadepth_mini` and its 608x800
map: the same JPEG bytes, PNG pixels, depth arrays and indices.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path
from unittest import mock

import cv2
import h5py
import numpy as np
import pytest

from torch_support import (HOLDOUT, HOLDOUT_SCENES, MEGADEPTH_DEPTH,
                           MEGADEPTH_MINI, ROOT)

BLOCKED = ("cv2", "h5py", "jax")


def _args(tex, out):
    """Each generator's arguments, shared by both packages."""
    md = str(out / "md")
    return {
        "render_depth_dataset": [
            "--out", md, "--textures", str(tex), "--scenes", "2",
            "--holdout_scenes", "1", "--views", "3", "--res", "96x72",
            "--quads", "4", "--textures_per_scene", "4", "--seed", "3",
            "--min_overlap", "0.05"],
        "render_scannet_fixture": [
            "--out", str(out / "scannet"), "--textures", str(tex),
            "--scenes", "2", "--views", "2", "--res", "96x72", "--seed",
            "4"],
        "make_eval_variants": [
            "--json", md + "/rendered_pose_pairs.json", "--data_root", md,
            "--max_dim", "640", "--out", md + "/pairs_640.json"],
    }


def _run_jax(app: str, argv):
    import importlib
    mod = importlib.import_module(f"apps.{app}")
    with mock.patch.object(sys, "argv", [app, *argv]):
        mod.main()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("datagen")
    tex = base / "textures"
    tex.mkdir()
    pngs = sorted(HOLDOUT.rglob("*.png"))
    for i, p in enumerate(pngs[:5]):
        shutil.copy(p, tex / f"t{i}.png")
    cv2.imwrite(str(tex / "t5.jpg"), cv2.imread(str(pngs[5])))
    (tex / "t6.png").write_bytes(b"not an image")
    jax_out, port_out = base / "jax", base / "port"
    for app, argv in _args(tex, jax_out).items():
        _run_jax(app, argv)
    calls = [f"from accelerated_features_tpu_torch.apps import {app}; "
             f"{app}.main({argv!r})"
             for app, argv in _args(tex, port_out).items()]
    fixture_args = ["--out", str(base / "fixture"), "--textures",
                    str(HOLDOUT_SCENES), "--full_size_out",
                    str(base / "full")]
    calls.append("from accelerated_features_tpu_torch.tools import "
                 f"make_megadepth_fixture as m; m.main({fixture_args!r})")
    code = "; ".join([f"import sys; sys.modules[{m!r}] = None"
                      for m in BLOCKED] + calls)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=600)
    return {"jax": jax_out, "port": port_out, "fixture": base / "fixture",
            "full": base / "full"}


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file() and p.name != "README.md")


def _same_file(a: Path, b: Path) -> bool:
    if a.suffix == ".png":
        return np.array_equal(cv2.imread(str(a)), cv2.imread(str(b)))
    if a.suffix in (".jpg", ".txt"):
        return a.read_bytes() == b.read_bytes()
    if a.suffix == ".h5":
        with h5py.File(a, "r") as x, h5py.File(b, "r") as y:
            dx, dy = x["depth"], y["depth"]
            meta = [(d.dtype, d.chunks, d.compression, d.compression_opts,
                     d.shuffle) for d in (dx, dy)]
            return np.array_equal(dx[()], dy[()]) and meta[0] == meta[1]
    if a.suffix == ".npy":
        x, y = np.load(a), np.load(b)
        return x.dtype == y.dtype and np.array_equal(x, y)
    if a.suffix == ".npz":
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        if x.files != y.files:
            return False
        for k in x.files:
            u, v = x[k], y[k]
            if u.dtype != v.dtype or u.shape != v.shape:
                return False
            for s, t in zip(u.reshape(-1), v.reshape(-1)):
                if isinstance(s, tuple):      # pair_infos: ((i, j), ov, nc)
                    if not (np.array_equal(s[0], t[0]) and s[1:] == t[1:]):
                        return False
                elif not np.array_equal(s, t):
                    return False
        return True
    if a.suffix == ".json":
        return json.loads(a.read_text()) == json.loads(b.read_text())
    raise AssertionError(f"unexpected file {a}")


def _same_tree(ref: Path, got: Path):
    files = _files(ref)
    assert files and files == _files(got)
    bad = [str(f) for f in files if not _same_file(ref / f, got / f)]
    assert not bad, f"differ: {bad}"
    return files


@pytest.mark.parametrize("part", ["md", "scannet"])
def test_generated_trees_equal_jax(trees, part):
    files = _same_tree(trees["jax"] / part, trees["port"] / part)
    kinds = {f.suffix for f in files}
    if part == "md":
        assert {".png", ".h5", ".npz", ".json"} <= kinds
        pairs = json.loads((trees["port"] / "md" /
                            "rendered_pose_pairs.json").read_text())
        v640 = json.loads((trees["port"] / "md" /
                           "pairs_640.json").read_text())
        assert pairs and len(v640) == len(pairs)
        assert v640[0]["size0_hw"] == [int(round(72 * 640 / 96)), 640]
        with h5py.File(next((trees["port"] / "md").rglob("*.h5")), "r") as f:
            assert f["depth"].compression == "gzip"
            assert f["depth"].compression_opts == 4
    else:
        assert {".jpg", ".txt", ".npy", ".npz"} <= kinds


@pytest.mark.parametrize("max_dim", [640, 1024])
def test_eval_variants_of_committed_manifest_equal_jax(tmp_path, max_dim):
    from accelerated_features_tpu_torch.apps import make_eval_variants
    args = ["--json", str(HOLDOUT / "rendered_pose_pairs.json"),
            "--data_root", str(HOLDOUT), "--max_dim", str(max_dim)]
    _run_jax("make_eval_variants", args + ["--out", str(tmp_path / "j")])
    make_eval_variants.main(args + ["--out", str(tmp_path / "p")])
    got = json.loads((tmp_path / "p").read_text())
    assert got == json.loads((tmp_path / "j").read_text())
    assert all(max(p["size0_hw"]) == max_dim for p in got)


def test_fixture_tool_reproduces_the_committed_fixture(trees):
    _same_tree(MEGADEPTH_MINI, trees["fixture"])
    _same_tree(MEGADEPTH_DEPTH, trees["full"])
