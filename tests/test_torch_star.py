"""The port's semi-dense XFeat* path against the JAX package, on the CPU:
the fine matcher, the dense selector, single- and dual-scale dense
extraction, the refinement, and `match_xfeat_star` end to end. The same
seeded numpy inputs and the trained extractor go through both packages;
tolerances are stated per test."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import XFeat as JaxXFeat
from accelerated_features_tpu.api import load_params as jax_load_params
from accelerated_features_tpu.models.backbone import \
    fine_matcher_forward as jax_fine_matcher_forward
from accelerated_features_tpu.ops import detect as jdetect
from accelerated_features_tpu.ops import extraction as jextraction
from accelerated_features_tpu.ops import matching as jmatching
from accelerated_features_tpu.ops import refine as jrefine
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.models.backbone import \
    fine_matcher_forward
from accelerated_features_tpu_torch.models.lighterglue import LighterGlue
from accelerated_features_tpu_torch.models.params import load_params
from accelerated_features_tpu_torch.ops import (detect, extraction, matching,
                                                refine)

from torch_support import CKPT, t



def texture(seed, h, w):
    """Seeded gray uint8 texture: blocky noise at three scales."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (4, 8, 16):
        g = rng.uniform(0, 1, (h // cell + 2, w // cell + 2))
        img += np.kron(g, np.ones((cell, cell)))[:h, :w]
    return (img / 3 * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def both_params():
    return jax_load_params(CKPT), load_params(CKPT)


@pytest.fixture(scope="module")
def models():
    return (JaxXFeat(weights=CKPT, top_k=512),
            XFeat(weights=CKPT, top_k=512, device="cpu"))


def test_fine_matcher_forward_matches_jax(both_params):
    """Folded BatchNorm, four Linear+ReLU and a Linear: atol 1e-4 on
    logits of magnitude ~10."""
    jp, tp = both_params
    x = np.random.default_rng(0).normal(size=(2, 37, 128)).astype(np.float32)
    ref = jax.jit(jax_fine_matcher_forward)(jp, jnp.asarray(x))
    got = fine_matcher_forward(tp, t(x))
    assert tuple(got.shape) == (2, 37, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_fine_matcher_needs_folded_batchnorm():
    raw = load_params(CKPT, fold_bn=False)
    with pytest.raises(ValueError, match="folded"):
        fine_matcher_forward(raw, torch.zeros(1, 128))


@pytest.mark.parametrize("n,k,ties", [(300, 64, False), (300, 64, True),
                                      (20, 32, True)])
def test_dense_topk_matches_jax(n, k, ties):
    """Identical indices, ties included (index order, as `lax.top_k`), and
    the padded tail when there are fewer than K cells."""
    rng = np.random.default_rng(n + k)
    rel = rng.uniform(0, 1, (2, n)).astype(np.float32)
    if ties:
        rel = np.round(rel * 8) / 8
    feats = rng.normal(size=(2, n, 64)).astype(np.float32)
    ridx, rfeat = jax.jit(functools.partial(jdetect.dense_topk, top_k=k))(
        feats, rel)
    gidx, gfeat = detect.dense_topk(t(feats), t(rel), k)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gfeat.numpy(), np.asarray(rfeat))


@pytest.mark.parametrize("multiscale,hw", [(False, (96, 128)),
                                           (True, (96, 128)),
                                           (True, (100, 140))])
def test_detect_and_compute_dense_matches_jax(both_params, multiscale, hw):
    """Keypoints and scales identical, descriptors (not normalized) within
    1e-4; (100,140) goes through the /32 resize at both scales."""
    jp, tp = both_params
    x = np.stack([texture(3, *hw), texture(4, *hw)])[..., None]
    ref = jax.jit(functools.partial(jextraction.detect_and_compute_dense,
                                    top_k=200, multiscale=multiscale))(jp, x)
    with torch.inference_mode():
        got = extraction.detect_and_compute_dense(tp, t(x), 200, multiscale)
    # the reliability top-k picks the same cells unless two reliabilities
    # differ by less than the packages' rounding; seeded inputs, none do
    np.testing.assert_array_equal(got["keypoints"].numpy(),
                                  np.asarray(ref["keypoints"]))
    np.testing.assert_array_equal(got["scales"].numpy(),
                                  np.asarray(ref["scales"]))
    np.testing.assert_allclose(got["descriptors"].numpy(),
                               np.asarray(ref["descriptors"]), atol=1e-4)
    norms = np.linalg.norm(got["descriptors"].numpy(), axis=-1)
    assert np.abs(norms - 1).max() > 0.05  # raw, not L2-normalized
    # each scale gives min(its share of top_k, its number of /8 cells)
    assert got["keypoints"].shape == ref["keypoints"].shape


def test_subpix_softmax2d_and_refine_match_jax(both_params):
    jp, tp = both_params
    rng = np.random.default_rng(5)
    b, k = 2, 50
    logits = rng.normal(size=(b, k, 64)).astype(np.float32) * 2
    ref = jrefine.subpix_softmax2d(jnp.asarray(logits))
    got = refine.subpix_softmax2d(t(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    kp0 = rng.uniform(0, 500, (b, k, 2)).astype(np.float32)
    kp1 = rng.uniform(0, 500, (b, k, 2)).astype(np.float32)
    d0 = rng.normal(size=(b, k, 64)).astype(np.float32)
    d1 = rng.normal(size=(b, k, 64)).astype(np.float32)
    sc = rng.choice([1 / 0.6, 1 / 1.3], (b, k)).astype(np.float32)
    idx1 = rng.integers(0, k, (b, k))
    mmask = rng.uniform(size=(b, k)) > 0.3
    # random descriptor pairs give confidences on both sides of the gate
    ref = jax.jit(functools.partial(jrefine.refine_matches, fine_conf=0.25))(
        jp, kp0, kp1, d0, d1, sc, idx1.astype(np.int32), mmask)
    got = refine.refine_matches(tp, t(kp0), t(kp1), t(d0), t(d1), t(sc),
                                t(idx1), t(mmask), fine_conf=0.25)
    for name, r, g in zip(("mkpts0", "mkpts1", "conf"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert 0 < int(got[3].sum()) < int(mmask.sum())


def test_batch_mnn_match_dense_matches_jax():
    rng = np.random.default_rng(6)
    d1 = rng.normal(size=(2, 90, 64)).astype(np.float32)
    d2 = (d1[:, ::-1] + 0.4 * rng.normal(size=d1.shape)).astype(np.float32)
    ridx, rmask = jax.jit(jmatching.batch_mnn_match_dense)(d1, d2)
    gidx, gmask = matching.batch_mnn_match_dense(t(d1), t(d2))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))


def star_pair(seed, h=160, w=192):
    im = texture(seed, h, w)
    return im, np.roll(im, (8, 16), axis=(0, 1))


def test_match_xfeat_star_single_pair_matches_jax(models):
    """Same matches, coordinates within 1e-3 px."""
    jx, tx = models
    im, im2 = star_pair(7)
    r0, r1 = jx.match_xfeat_star(im, im2)
    g0, g1 = tx.match_xfeat_star(im, im2)
    assert len(r0) > 20 and g0.shape == r0.shape
    np.testing.assert_array_equal(g1, r1)  # gathered coarse keypoints
    np.testing.assert_allclose(g0, r0, atol=1e-3)


def test_match_xfeat_star_batch_matches_jax(models):
    jx, tx = models
    a0, a1 = star_pair(8)
    b0, b1 = star_pair(9)
    ref = jx.match_xfeat_star(np.stack([a0, b0]), np.stack([a1, b1]))
    got = tx.match_xfeat_star(np.stack([a0, b0]), np.stack([a1, b1]))
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert len(r) > 20 and g.shape == r.shape and g.shape[1] == 4
        np.testing.assert_array_equal(g[:, 2:], r[:, 2:])
        np.testing.assert_allclose(g[:, :2], r[:, :2], atol=1e-3)


def test_refine_matches_api_matches_jax(models):
    """The per-item entry: dense extraction, `batch_match`, then
    `refine_matches` on item 1 of a batch of two."""
    jx, tx = models
    a0, a1 = star_pair(8)
    b0, b1 = star_pair(9)
    x0, x1 = np.stack([a0, b0]), np.stack([a1, b1])
    jd0, jd1 = jx.detectAndComputeDense(x0), jx.detectAndComputeDense(x1)
    td0, td1 = tx.detectAndComputeDense(x0), tx.detectAndComputeDense(x1)
    np.testing.assert_array_equal(td0["keypoints"].numpy(), jd0["keypoints"])
    jm = jx.batch_match(jd0["descriptors"], jd1["descriptors"])
    tm = tx.batch_match(td0["descriptors"], td1["descriptors"])
    ref = jx.refine_matches(jd0, jd1, jm, batch_idx=1)
    got = tx.refine_matches(td0, td1, tm, batch_idx=1)
    assert len(ref) > 20 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got[:, 2:].numpy(), ref[:, 2:])
    np.testing.assert_allclose(got[:, :2].numpy(), ref[:, :2], atol=1e-3)


def test_new_entry_points_run_where_the_extractor_runs(monkeypatch):
    """Without a GPU and without `device`, none of the LighterGlue and
    XFeat* entry points can be reached: the extractor refuses to be built,
    and the matcher takes no default device. With device='cpu' the
    matcher's weights follow the extractor's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XFeat(weights=CKPT)
    with pytest.raises(TypeError):
        LighterGlue(None)  # device is required
    tx = XFeat(weights=CKPT, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM weights"):
        matcher = tx.set_lighterglue()
    assert matcher.device == tx.device == torch.device("cpu")
    assert matcher.params["posenc_wr"].device.type == "cpu"
    out = tx.detectAndComputeDense(texture(1, 64, 96), top_k=50)
    assert out["keypoints"].device.type == "cpu"
