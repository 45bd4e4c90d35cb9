"""The port's `apps/make_synthetic_pool.py` against the JAX package's root
`apps/make_synthetic_pool.py`, on the CPU.

The JAX app runs in this process with cv2; the port's CLI runs in one
subprocess in which `cv2`, `h5py` and `jax` cannot be imported. Both make
the same files, from the same seeds:

- style v1 at 96x72 for seeds 0, 1 and 2 and at 800x608 for seed 0
  (`--n 16 --holdout 4`, the pool `chip_smoke.py` makes): PNG pixels
  equal to the JAX app's as cv2 runs by default (its IPP cubic resize,
  which `utils/imageio.resize` computes to the bit), and at 96x72 also to
  the JAX app's with `cv2.ipp.setUseIPP(False)`, whose own resize rounds
  the value noise otherwise: at 800x608 at most 8 pixels an image differ
  from that, by one level;
- the sha256 of each v1 800x608 image's pixels, from both apps, equal
  to `tests/fixtures/synthetic_pool_v1_s0_800x608.json`, which
  `chip_smoke.py` checks the port's pool against on the card's host;
- style v2 with the text drawn by neither package (`cv2.putText` and
  `put_text` patched to no-ops): whole images equal, with cv2's IPP on
  and off;
- style v2 with text: the generators' states equal after every image, and
  at most 0.2 % of an image's pixels (0.05 % over the pool) differ, by at
  most 8 levels (the port measured 1 level and under 0.06 %): the text of
  `tests/test_torch_text.py`'s tolerance;
- `tools/pool_ab.py` runs its four turns (here on one checkout).
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import cv2
import numpy as np
import pytest

from torch_support import FIXTURES, ROOT

BLOCKED = ("cv2", "h5py", "jax")

# name -> the CLI arguments both apps take (the output dir is appended)
RUNS = {
    "v1_96_s0": ["--style", "v1", "--res", "96x72", "--n", "3",
                 "--holdout", "1", "--seed", "0"],
    "v1_96_s1": ["--style", "v1", "--res", "96x72", "--n", "3",
                 "--holdout", "1", "--seed", "1"],
    "v1_96_s2": ["--style", "v1", "--res", "96x72", "--n", "3",
                 "--holdout", "1", "--seed", "2"],
    "v1_800_s0": ["--style", "v1", "--n", "16", "--holdout", "4",
                  "--seed", "0", "--res", "800x608"],
    "v2_96_s0": ["--style", "v2", "--res", "96x72", "--n", "10",
                 "--holdout", "2", "--seed", "0", "--prefix", "syn"],
    "v2_800_s0": ["--res", "800x608", "--n", "3", "--holdout", "1"],
}
V1 = [name for name in RUNS if name.startswith("v1")]
DIGESTS = FIXTURES / "synthetic_pool_v1_s0_800x608.json"


def _jax_app():
    import apps.make_synthetic_pool as app
    return app


def _run_jax(name, out, ipp):
    app = _jax_app()
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        with mock.patch.object(sys, "argv", ["make_synthetic_pool",
                                             *RUNS[name], "--out", str(out)]):
            app.main()
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    base = tmp_path_factory.mktemp("pool")
    for name in RUNS:
        _run_jax(name, base / "jax" / name, ipp=False)
    for name in V1 + ["v2_800_s0"]:
        _run_jax(name, base / "jax_ipp" / name, ipp=True)
    calls = ["from accelerated_features_tpu_torch.apps import "
             "make_synthetic_pool as m", "summaries = []"]
    for name, argv in RUNS.items():
        out = str(base / "port" / name)
        calls.append(f"summaries.append(m.main({argv + ['--out', out]!r}))")
    calls.append("assert all(s['seconds'] > 0 for s in summaries)")
    code = "; ".join([f"import sys; sys.modules[{m!r}] = None"
                      for m in BLOCKED] + calls)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=600)
    return base


def _pngs(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*.png"))


def _pairs(pools, ref, name):
    """(relative path, JAX image, port image) of every file of a run, its
    holdout dir included."""
    out = []
    for suffix in ("", "_holdout"):
        a_dir = pools / ref / (name + suffix)
        b_dir = pools / "port" / (name + suffix)
        files = _pngs(a_dir)
        assert files and files == _pngs(b_dir)
        for f in files:
            a, b = cv2.imread(str(a_dir / f)), cv2.imread(str(b_dir / f))
            assert a is not None and b is not None and a.shape == b.shape
            out.append((name + suffix + "/" + str(f), a, b))
    return out


def test_file_names_and_counts_equal_jax(pools):
    for name, argv in RUNS.items():
        n = int(argv[argv.index("--n") + 1])
        hold = int(argv[argv.index("--holdout") + 1])
        pairs = _pairs(pools, "jax", name)
        assert len(pairs) == n + hold
        prefix = argv[argv.index("--prefix") + 1] if "--prefix" in argv \
            else "img"
        assert all(p[0].split("/")[1].startswith(prefix + "_")
                   for p in pairs)
        w, h = (96, 72) if "96x72" in argv else (800, 608)
        assert all(p[1].shape == (h, w, 3) for p in pairs)


@pytest.mark.parametrize("ref,name", [("jax_ipp", n) for n in V1]
                         + [("jax", n) for n in V1 if "_96_" in n])
def test_v1_pngs_equal_jax(pools, ref, name):
    for path, a, b in _pairs(pools, ref, name):
        assert np.array_equal(a, b), path


def test_v1_800_against_cv2_without_ipp(pools):
    """cv2's own cubic resize rounds the value noise otherwise than its
    default (IPP), which the port computes: the JAX app's PNGs made with
    `setUseIPP(False)` differ in 0-4 pixels an image, by one level."""
    for path, a, b in _pairs(pools, "jax", "v1_800_s0"):
        d = np.abs(a.astype(np.int64) - b)
        assert d.max() <= 1, path
        assert (d > 0).any(-1).sum() <= 8, path


def test_v1_pool_digests_equal_the_committed_file(pools):
    from accelerated_features_tpu_torch.apps.make_synthetic_pool import (
        pool_digests)
    held = json.loads(DIGESTS.read_text())
    assert held["command"].split()[2:-2] == RUNS["v1_800_s0"]
    assert (held["cv2"], held["ipp"]) == (cv2.__version__,
                                          cv2.ipp.getIppVersion()), (
        f"the digests are of cv2 {held['cv2']} with IPP {held['ipp']!r}; "
        f"this is cv2 {cv2.__version__} with {cv2.ipp.getIppVersion()!r}")
    jax = {}
    for part, suffix in (("train", ""), ("holdout", "_holdout")):
        for f in _pngs(pools / "jax_ipp" / ("v1_800_s0" + suffix)):
            im = cv2.imread(str(pools / "jax_ipp" / ("v1_800_s0" + suffix)
                                / f))
            jax[f"{part}/{f}"] = hashlib.sha256(
                np.ascontiguousarray(im).tobytes()).hexdigest()
    assert len(held["images"]) == 20
    assert jax == held["images"]
    assert pool_digests(str(pools / "port" / "v1_800_s0")) == held["images"]


@pytest.mark.parametrize("ipp", [False, True])
@pytest.mark.parametrize("hw,n", [((72, 96), 16), ((608, 800), 3)])
def test_v2_without_text_equals_jax(hw, n, ipp):
    from accelerated_features_tpu_torch.apps import make_synthetic_pool as port
    app = _jax_app()
    h, w = hw
    rj, rp = np.random.default_rng(5), np.random.default_rng(5)
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        with mock.patch.object(cv2, "putText", lambda *a, **k: None), \
                mock.patch.object(port, "put_text", lambda *a, **k: None):
            for i in range(n):
                a = app.make_image_v2(rj, h, w)
                b = port.make_image_v2(rp, h, w)
                assert a.dtype == b.dtype == np.uint8
                assert np.array_equal(a, b), i
    finally:
        cv2.ipp.setUseIPP(was)
    assert rj.bit_generator.state == rp.bit_generator.state


def test_v2_with_text_keeps_the_generator_in_step():
    from accelerated_features_tpu_torch.apps import make_synthetic_pool as port
    app = _jax_app()
    rj, rp = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(24):
        app.make_image_v2(rj, 72, 96)
        port.make_image_v2(rp, 72, 96)
        assert rj.bit_generator.state == rp.bit_generator.state, i


@pytest.mark.parametrize("ref,name", [("jax", "v2_96_s0"),
                                      ("jax", "v2_800_s0"),
                                      ("jax_ipp", "v2_800_s0")])
def test_v2_with_text_within_the_text_tolerance(pools, ref, name):
    diff = total = 0
    for path, a, b in _pairs(pools, ref, name):
        d = np.abs(a.astype(np.int64) - b)
        px = (d > 0).any(-1)
        assert d.max() <= 8, path
        assert px.mean() <= 0.002, path
        diff += px.sum()
        total += px.size
    assert diff <= 0.0005 * total


def test_pool_ab_times_both_checkouts():
    from accelerated_features_tpu_torch.tools import pool_ab
    out = pool_ab.main(["--a", str(ROOT), "--b", str(ROOT), "--n", "1",
                        "--res", "96x72"])
    assert out["a_s_per_image"] > 0 and out["b_s_per_image"] > 0
    assert 0 < out["b_over_a"] < 10
