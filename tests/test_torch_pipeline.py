"""The port's sparse XFeat slice against the JAX package's, on the CPU,
plus the port's guards: no JAX import, no silent CPU fallback."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import XFeat as JaxXFeat
from accelerated_features_tpu_torch import XFeat

ROOT = Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "artifacts" / "run_md_ckpt13250.npz")


def texture(seed, h, w):
    """Seeded gray uint8 texture: blocky noise at three scales."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (4, 8, 16):
        g = rng.uniform(0, 1, (h // cell + 2, w // cell + 2))
        img += np.kron(g, np.ones((cell, cell)))[:h, :w]
    return (img / 3 * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    return (JaxXFeat(weights=CKPT, top_k=256),
            XFeat(weights=CKPT, top_k=256, device="cpu"))


def _by_position(kpts, *arrays):
    order = np.lexsort((kpts[:, 0], kpts[:, 1]))
    return [kpts[order]] + [a[order] for a in arrays]


@pytest.mark.parametrize("hw", [(96, 128), (100, 140)])
def test_detect_and_compute_matches_jax(models, hw):
    jx, tx = models
    im = texture(0, *hw)
    ref = jx.detectAndCompute(im)[0]
    got = {k: v.numpy() for k, v in tx.detectAndCompute(im)[0].items()}
    assert len(ref["keypoints"]) > 50
    rk, rs, rd = _by_position(ref["keypoints"], ref["scores"],
                              ref["descriptors"])
    gk, gs, gd = _by_position(got["keypoints"], got["scores"],
                              got["descriptors"])
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gs, rs, atol=1e-5)
    np.testing.assert_allclose(gd, rd, atol=1e-4)


@pytest.mark.parametrize("hw", [(96, 128), (100, 140)])
def test_match_xfeat_matches_jax(models, hw):
    jx, tx = models
    im = texture(1, *hw)
    im2 = np.roll(im, (8, 16), axis=(0, 1))
    r0, r1 = jx.match_xfeat(im, im2)
    g0, g1 = tx.match_xfeat(im, im2)
    assert len(r0) > 20
    np.testing.assert_array_equal(g0, r0)
    np.testing.assert_array_equal(g1, r1)


def test_match_xfeat_on_rendered_holdout_matches_jax(models):
    """One pair of the committed rendered pose holdout (800x608 PNGs),
    top_k 1024: the port's `match_xfeat` returns the JAX package's matched
    keypoint pairs, compared as sets. On real images the two packages'
    scores differ by up to 3e-4 (float32 rounding of keypoint logits that
    reach |500|), so neighbours with nearly equal scores may swap places
    in the score-sorted output; the sets of keypoints and of matched pairs
    are identical."""
    cv2 = pytest.importorskip("cv2")
    scene = (ROOT / "artifacts" / "rendered_pose_holdout" / "MegaDepth_v1"
             / "rendered" / "holdout_0012" / "imgs")
    im0 = cv2.imread(str(scene / "view_0.png"))
    im1 = cv2.imread(str(scene / "view_1.png"))
    assert im0 is not None and im0.shape == (608, 800, 3)
    jx, tx = models
    r0, r1 = jx.match_xfeat(im0, im1, top_k=1024)
    g0, g1 = tx.match_xfeat(im0, im1, top_k=1024)
    assert len(r0) > 100 and g0.shape == r0.shape
    ref = {tuple(row) for row in np.concatenate([r0, r1], 1).tolist()}
    got = {tuple(row) for row in np.concatenate([g0, g1], 1).tolist()}
    assert len(ref) == len(r0) and got == ref


@pytest.mark.parametrize("n1,n2,min_cossim", [(70, 50, 0.82), (40, 129, -1.0)])
def test_match_bucketed_padding_matches_jax(models, n1, n2, min_cossim):
    jx, tx = models
    rng = np.random.default_rng(n1)
    d1 = rng.normal(size=(n1, 64)).astype(np.float32)
    m = min(n1, n2 // 2)
    d2 = np.concatenate([d1[:m] + 0.3 * rng.normal(size=(m, 64)),
                         rng.normal(size=(n2 - m, 64))]).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    r0, r1 = jx.match(d1, d2, min_cossim=min_cossim)
    g0, g1 = tx.match(d1, d2, min_cossim=min_cossim)
    assert len(r0) > 5
    np.testing.assert_array_equal(g0.numpy(), r0)
    np.testing.assert_array_equal(g1.numpy(), r1)


def test_batch_match_matches_jax(models):
    jx, tx = models
    rng = np.random.default_rng(5)
    d1 = rng.normal(size=(3, 90, 64)).astype(np.float32)
    d2 = (d1[:, ::-1] + 0.4 * rng.normal(size=d1.shape)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    for (r0, r1), (g0, g1) in zip(jx.batch_match(d1, d2),
                                  tx.batch_match(d1, d2)):
        np.testing.assert_array_equal(g0.numpy(), r0)
        np.testing.assert_array_equal(g1.numpy(), r1)


@pytest.mark.parametrize("kind", ["gray2d", "gray_batch", "rgb_uint8",
                                  "float255", "float01"])
def test_parse_input_matches_jax(models, kind):
    jx, tx = models
    g = texture(2, 64, 96)
    x = {"gray2d": g, "gray_batch": np.stack([g, g[::-1]]),
         "rgb_uint8": np.stack([g, g[::-1], 255 - g], -1),
         "float255": g.astype(np.float32),
         "float01": g.astype(np.float32) / 255.0}[kind]
    ref = np.asarray(jx.parse_input(x))
    got = tx.parse_input(x).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-7)


PORT_FILES = sorted(p for p in (ROOT / "accelerated_features_tpu_torch")
                    .rglob("*.py") if "_build" not in p.parts)


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "accelerated_features_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_xfeat_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XFeat()
