"""The port's LighterGlue and the plain version of its attention kernel
against the JAX package, on the CPU.

The same seeded numpy inputs and the same weights (the trained matcher
`artifacts/lighterglue_ft_ckpt7791.npz`, carried across with the port's
loader) go through the JAX function and the port's counterpart. The Pallas
attention kernel runs in interpret mode. Tolerances are stated per test."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import XFeat as JaxXFeat
from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.ops.pallas.attention import (
    attention_reference as jax_attention_reference)
from accelerated_features_tpu.ops.pallas.attention import \
    flash_attention as jax_flash_attention
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.models import lighterglue as lg
from accelerated_features_tpu_torch.models.params import (
    load_lighterglue_params, load_npz_tree)
from accelerated_features_tpu_torch.ops.cuda import attention

ROOT = Path(__file__).resolve().parents[1]
LG_CKPT = str(ROOT / "artifacts" / "lighterglue_ft_ckpt7791.npz")
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_pallas_attention.py's


def t(a):
    return torch.tensor(np.asarray(a))


def texture(seed, h, w):
    """Seeded gray uint8 texture: blocky noise at three scales."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (4, 8, 16):
        g = rng.uniform(0, 1, (h // cell + 2, w // cell + 2))
        img += np.kron(g, np.ones((cell, cell)))[:h, :w]
    return (img / 3 * 255).astype(np.uint8)


def qkv(seed, b, nq, nk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, nq, d)).astype(np.float32),
            rng.normal(size=(b, nk, d)).astype(np.float32),
            rng.normal(size=(b, nk, d)).astype(np.float32))


# ---- kernel D's plain version ---------------------------------------------

@pytest.mark.parametrize("nq,nk,d,masked", [
    (100, 80, 96, False), (256, 512, 96, False), (300, 300, 64, False),
    (64, 128, 96, True), (100, 80, 96, True)])
def test_attention_plain_matches_jax(nq, nk, d, masked):
    """Against the dense JAX attention and against the Pallas kernel in
    interpret mode; `flash_attention` on CPU tensors is the plain version."""
    q, k, v = qkv(nq, 2, nq, nk, d)
    mask = (np.random.default_rng(1).uniform(size=(2, nk)) > 0.4
            if masked else None)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else t(mask)
    dense = np.asarray(jax.jit(jax_attention_reference)(q, k, v, jmask))
    pallas = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jmask,
                                            interpret=True))
    n = attention.flash_attention.launches
    got = attention.flash_attention(t(q), t(k), t(v), tmask).numpy()
    assert attention.flash_attention.launches == n  # no kernel on the CPU
    np.testing.assert_allclose(got, dense, **ATTN_TOL)
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)
    ref = attention.attention_reference(t(q), t(k), t(v), tmask).numpy()
    np.testing.assert_array_equal(got, ref)


def test_attention_plain_padding_invariance():
    """Masked-out padded keys never contribute, whatever their values."""
    b, nq, nk, d, pad = 1, 32, 48, 32, 16
    q, k, v = qkv(2, b, nq, nk, d)
    base = attention.attention_reference(t(q), t(k), t(v)).numpy()
    k2 = np.concatenate([k, 100.0 * np.ones((b, pad, d), np.float32)], 1)
    v2 = np.concatenate([v, -50.0 * np.ones((b, pad, d), np.float32)], 1)
    mask = np.arange(nk + pad)[None] < nk
    got = attention.attention_reference(t(q), t(k2), t(v2), t(mask)).numpy()
    np.testing.assert_allclose(got, base, **ATTN_TOL)
    pallas = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(mask),
        interpret=True))
    np.testing.assert_allclose(got, pallas, **ATTN_TOL)


def test_attention_plain_fully_masked_row_is_mean_of_v():
    """Every key masked: all scores are -1e9, the softmax is uniform, and
    the output is the mean of V over the Nk keys (not zero, not NaN), as
    the JAX package's dense attention gives."""
    q, k, v = qkv(3, 2, 20, 24, 96)
    mask = np.ones((2, 24), bool)
    mask[1] = False
    got = attention.attention_reference(t(q), t(k), t(v), t(mask)).numpy()
    ref = np.asarray(jax.jit(jax_attention_reference)(q, k, v,
                                                      jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, **ATTN_TOL)
    np.testing.assert_allclose(
        got[1], np.broadcast_to(v[1].mean(0), got[1].shape), atol=1e-6)


# ---- LighterGlue's pieces, one by one (atol 1e-5) --------------------------

@pytest.fixture(scope="module")
def params():
    """(JAX tree, port tree) of the trained matcher."""
    tree = load_npz_tree(LG_CKPT)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        load_lighterglue_params(LG_CKPT)


def test_lighterglue_params_layout(params):
    jp, tp = params
    assert len(tp["layers"]) == 6 and len(tp["token_confidence"]) == 6
    assert tuple(tp["posenc_wr"].shape) == (2, 48)  # not transposed
    assert tuple(tp["input_proj"]["w"].shape) == (96, 64)  # (out, in)
    np.testing.assert_array_equal(tp["layers"][3]["self"]["qkv"]["w"].numpy(),
                                  np.asarray(jp["layers"][3]["self"]["qkv"]
                                             ["w"]).T)
    rand = lg.init_lighterglue_params(torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(rand) == shapes(tp)


def test_normalize_keypoints_and_rotary_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    kpts = rng.uniform(0, 600, (2, 30, 2)).astype(np.float32)
    size = np.array([[800, 608], [480, 640]], np.float32)
    ref_n = jlg.normalize_keypoints(jnp.asarray(kpts), jnp.asarray(size))
    got_n = lg.normalize_keypoints(t(kpts), t(size))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), atol=1e-6)
    ref_c, ref_s = jlg.rotary_encoding(ref_n, jp["posenc_wr"])
    got_c, got_s = lg.rotary_encoding(got_n, tp["posenc_wr"])
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    x = rng.normal(size=(2, 30, 96)).astype(np.float32)
    ref = jlg.apply_rotary(jnp.asarray(x), ref_c, ref_s)
    got = lg.apply_rotary(t(x), got_c, got_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_sigmoid_log_double_softmax_and_filter_match_jax():
    rng = np.random.default_rng(5)
    b, m, n = 2, 12, 9
    sim = rng.normal(size=(b, m, n)).astype(np.float32) * 3
    z0 = rng.normal(size=(b, m)).astype(np.float32)
    z1 = rng.normal(size=(b, n)).astype(np.float32)
    mask0 = np.arange(m)[None] < np.array([[m], [7]])
    mask1 = np.arange(n)[None] < np.array([[5], [n]])
    ref = np.asarray(jlg.sigmoid_log_double_softmax(
        *map(jnp.asarray, (sim, z0, z1, mask0, mask1))))
    got = lg.sigmoid_log_double_softmax(*map(t, (sim, z0, z1, mask0, mask1)))
    assert got.shape == ref.shape == (b, m + 1, n + 1)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(ref))
    fin = np.isfinite(ref)
    # entries of masked points sit near -1e9, where float32 steps by 64
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=1e-5,
                               rtol=1e-6)
    r0, rs = jlg.filter_matches_from_scores(jnp.asarray(ref), m, n)
    g0, gs = lg.filter_matches_from_scores(t(ref), m, n)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(r0))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=1e-5)


def test_filter_matches_takes_first_index_on_ties():
    """Rows that are all -1e9 or -inf (padded or pruned points) tie
    everywhere; both packages then take index 0."""
    scores = np.full((1, 5, 4), -1e9, np.float32)
    scores[0, :, 3] = -np.inf
    scores[0, 4, :] = -np.inf
    scores[0, 1, 2] = -0.1
    r0, rs = jlg.filter_matches_from_scores(jnp.asarray(scores), 4, 3)
    g0, gs = lg.filter_matches_from_scores(t(scores), 4, 3)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(r0))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=1e-7)
    assert g0.numpy().tolist() == [[0, 2, -1, -1]]


# ---- the forward as a whole ------------------------------------------------

def small_inputs(seed, m, n, n0, n1):
    rng = np.random.default_rng(seed)
    b = len(n0)
    k0 = rng.uniform(0, [800, 608], (b, m, 2)).astype(np.float32)
    d0 = rng.normal(size=(b, m, 64)).astype(np.float32)
    perm = rng.permutation(m)[:n]
    k1 = (k0[:, perm] + rng.normal(size=(b, n, 2)) * 2).astype(np.float32)
    d1 = (d0[:, perm] + 0.2 * rng.normal(size=(b, n, 64))).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    size = np.tile(np.array([[800, 608]], np.float32), (b, 1))
    mask0 = np.arange(m)[None] < np.array(n0)[:, None]
    mask1 = np.arange(n)[None] < np.array(n1)[:, None]
    return k0, k1, d0, d1, size, size, mask0, mask1


def two_layers(tree):
    return {**tree, "layers": tree["layers"][:2],
            "assignments": tree["assignments"][:2]}


@pytest.mark.parametrize("width_confidence", [-1.0, 0.95, 0.55],
                         ids=["no_pruning", "pruning_0.95", "pruning_0.55"])
def test_lighterglue_forward_matches_jax(params, width_confidence):
    """2 layers, M=48, N=40, ragged masks, pruning off and on
    (pruning_min_kpts=0). At the published width_confidence 0.95 these
    inputs lose no point (layer-0 matchabilities lie in 0.38..0.65); at
    0.55 the points below 0.45 go, none within 1e-3 of that threshold.
    log_assignment within 1e-4 where finite (entries of masked
    or pruned points sit near -1e9, where float32 steps by 64: rtol 1e-6)
    and -inf in the same places; matches0 identical on real rows; on
    padded rows both packages give score 0, so those rows are dropped
    whatever index the all-tied argmax took; mscores0 within 1e-5."""
    jp, tp = (two_layers(p) for p in params)
    inputs = small_inputs(6, 48, 40, (48, 31), (33, 40))
    kw = dict(heads=1, width_confidence=width_confidence, pruning_min_kpts=0)
    ref = jax.jit(functools.partial(jlg.lighterglue_forward, **kw))(
        jp, *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got = lg.lighterglue_forward(tp, *map(t, inputs), **kw)
    ra, ga = np.asarray(ref["log_assignment"]), got["log_assignment"].numpy()
    assert ga.shape == ra.shape == (2, 49, 41)
    np.testing.assert_array_equal(np.isneginf(ga), np.isneginf(ra))
    fin = np.isfinite(ra)
    np.testing.assert_allclose(ga[fin], ra[fin], atol=1e-4, rtol=1e-6)
    mask0 = inputs[6]
    r0, g0 = np.asarray(ref["matches0"]), got["matches0"].numpy()
    rs, gs = np.asarray(ref["mscores0"]), got["mscores0"].numpy()
    np.testing.assert_array_equal(g0[mask0], r0[mask0])
    np.testing.assert_allclose(gs, rs, atol=1e-5)
    assert not gs[~mask0].any() and not rs[~mask0].any()
    assert (g0[mask0] >= 0).sum() > 10
    # a pruned point against a kept one scores about -1e9
    real = mask0[:, :, None] & inputs[7][:, None, :]
    n_pruned = ((ra[:, :48, :40] < -1e8) & real).sum()
    assert (n_pruned > 0) == (width_confidence == 0.55)


def test_attention_multi_head_plain_matches_jax():
    """heads > 1 folds the heads into the batch; on CPU tensors that runs
    the attention kernel's plain version."""
    q, k, v = qkv(7, 2, 20, 24, 96)
    mask = np.random.default_rng(7).uniform(size=(2, 24)) > 0.3
    ref = jax.jit(functools.partial(jlg._attention, heads=2))(
        q, k, v, jnp.asarray(mask))
    got = lg._attention(t(q), t(k), t(v), t(mask), heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("n0,n1", [(70, 50), (12, 30)])
def test_lighterglue_match_matches_jax(n0, n1):
    """`LighterGlue.match` with the trained weights on seeded descriptors:
    bucket padding (128 and 32), identical index pairs."""
    k0, k1, d0, d1, *_ = small_inputs(n0, 80, 60, (80,), (60,))
    f0 = {"keypoints": k0[0, :n0], "descriptors": d0[0, :n0],
          "image_size": (800, 608)}
    f1 = {"keypoints": k1[0, :n1], "descriptors": d1[0, :n1],
          "image_size": (800, 608)}
    ref = jlg.LighterGlue(weights=LG_CKPT).match(f0, f1)
    got = lg.LighterGlue(LG_CKPT, "cpu").match(f0, f1)
    assert got.dtype == torch.int64 and len(ref) > 5
    np.testing.assert_array_equal(got.numpy(), ref)


def test_match_lighterglue_api_matches_jax():
    """`XFeat.match_lighterglue` end to end on extracted features; without
    loaded weights it raises, random weights warn."""
    im = texture(2, 192, 256)
    im2 = np.roll(im, (8, 16), axis=(0, 1))
    ckpt = str(ROOT / "artifacts" / "run_md_ckpt13250.npz")
    jx = JaxXFeat(weights=ckpt, top_k=256)
    tx = XFeat(weights=ckpt, top_k=256, device="cpu")
    size = {"image_size": (im.shape[1], im.shape[0])}
    j0, j1 = ({**jx.detectAndCompute(i)[0], **size} for i in (im, im2))
    t0, t1 = ({**tx.detectAndCompute(i)[0], **size} for i in (im, im2))
    np.testing.assert_array_equal(t0["keypoints"].numpy(), j0["keypoints"])
    with pytest.raises(RuntimeError, match="weights are not loaded"):
        tx.match_lighterglue(t0, t1)
    jx.set_lighterglue(weights=LG_CKPT)
    tx.set_lighterglue(weights=LG_CKPT)
    r0, r1, ridx = jx.match_lighterglue(j0, j1)
    g0, g1, gidx = tx.match_lighterglue(t0, t1)
    assert len(ridx) > 5
    np.testing.assert_array_equal(gidx.numpy(), ridx)
    np.testing.assert_array_equal(g0.numpy(), r0)
    np.testing.assert_array_equal(g1.numpy(), r1)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        matcher = tx.set_lighterglue()
    assert tuple(matcher.params["posenc_wr"].shape) == (2, 48)
    assert tx.match_lighterglue(t0, t1)[2].shape[1] == 2
