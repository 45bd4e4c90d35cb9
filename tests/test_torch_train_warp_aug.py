"""CPU parity of the port's ground-truth generation (`train/warp.py`) and
synthetic augmentation (`train/augmentation.py`) against the JAX package,
batched here and `vmap`ped there, on the same numpy-seeded inputs and the
same random draws (JAX's own draws, reproduced from its keys where the
port builds the transform from draws).

Tolerances: coordinates atol 1e-3 px (float32 warps through an inverse
homography and a 63-point TPS, summed in other orders); rendered pixel
values atol 1e-4; masks decided by an integer cast or a bound of such a
coordinate agree on at least 97% (correspondences) and 98% (depth warps)
of the rows, since a coordinate within rounding of a cell boundary may
fall on either side; the rows both keep agree in value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.train import augmentation as ja
from accelerated_features_tpu.train import warp as jw
from accelerated_features_tpu_torch.train import augmentation as ta
from accelerated_features_tpu_torch.train import warp as tw
from accelerated_features_tpu_torch.train.render import render_scene_views

from torch_support import t

RES = (128, 96)  # (W, H)
HW = (96, 128)
DIFFICULTY = 0.1  # make_pair's default
CFG_J = ja.AugConfig(warp_resolution=RES, out_resolution=RES)
CFG_T = ta.AugConfig(warp_resolution=RES, out_resolution=RES)
B = 2


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def transforms():
    """JAX-drawn homographies and TPS (its own keys) and the port's
    transforms built from the same draws."""
    keys = jax.random.split(jax.random.key(0), 3 * B)
    H1 = np.stack([np.asarray(ja.random_homography(k, HW, DIFFICULTY))
                   for k in keys[:B]])
    H2 = np.stack([np.asarray(ja.random_homography(k, HW, DIFFICULTY))
                   for k in keys[B:2 * B]])
    tps = [ja.random_tps(k, (8, 6), DIFFICULTY, prob=1.0)
           for k in keys[2 * B:]]
    tps_j = tuple(np.stack([np.asarray(t[i]) for t in tps]) for i in range(4))

    def draws(key):  # the draws of JAX's random_homography
        k = jax.random.split(key, 6)
        d = DIFFICULTY
        return (jax.random.uniform(k[0], (), minval=-30.0, maxval=30.0),
                jax.random.uniform(k[1], (2,), minval=0.35, maxval=1.2),
                jax.random.normal(k[2], (2,)) * 120.0 * d,
                jax.random.normal(k[3], (2,)) * 0.6 * d,
                jax.random.normal(k[4], (2,)) * 0.006 * d)

    def port_h(ks):
        cols = list(zip(*[draws(k) for k in ks]))
        return ta.homography_from_draws(*[t(np.stack(c)) for c in cols],
                                        HW)
    offs = np.stack([np.asarray(jax.random.uniform(
        jax.random.split(k)[0], (63, 2))) for k in keys[2 * B:]])
    apply_u = np.stack([np.asarray(jax.random.uniform(
        jax.random.split(k)[1], ())) for k in keys[2 * B:]])
    tps_t = ta.tps_from_draws(t(offs), t(apply_u), (8, 6), DIFFICULTY,
                              prob=1.0)
    return {"H1": H1, "H2": H2, "tps": tps_j,
            "H1_t": port_h(keys[:B]), "H2_t": port_h(keys[B:2 * B]),
            "tps_t": tps_t}


def test_homography_and_tps_from_jax_draws(transforms):
    np.testing.assert_allclose(_n(transforms["H1_t"]), transforms["H1"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(transforms["H2_t"]), transforms["H2"],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(transforms["tps_t"], transforms["tps"]):
        np.testing.assert_allclose(_n(a), b, rtol=1e-4, atol=1e-4)


def _images(seed=1, b=B):
    rng = np.random.default_rng(seed)
    g = rng.uniform(size=(b, 12, 16, 3)).astype(np.float32)
    return np.asarray(jax.image.resize(g, (b,) + HW + (3,), "bicubic"))


def _pair_j(t):
    return {"H1": jnp.asarray(t["H1"]), "H2": jnp.asarray(t["H2"]),
            "tps2": tuple(jnp.asarray(x) for x in t["tps"])}


def test_render_view_and_view2_to_view1(transforms):
    imgs = _images()
    for tps_j, tps_t in ((None, None), (transforms["tps"],
                                        transforms["tps_t"])):
        jv, jm = jax.vmap(lambda im, h, *tp: ja.render_view(
            im, h, CFG_J, tp if tp else None))(
            jnp.asarray(imgs), jnp.asarray(transforms["H2"]),
            *([jnp.asarray(x) for x in tps_j] if tps_j else []))
        tv, tm = ta.render_view(t(imgs), t(transforms["H2"]), CFG_T,
                                None if tps_t is None else
                                tuple(t(_n(x)) for x in tps_j))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    pts = np.random.default_rng(2).uniform(0, 96, (B, 50, 2)) \
        .astype(np.float32)
    jp = jax.vmap(lambda p, h1, h2, *tp: ja.view2_to_view1(
        p, h1, h2, CFG_J, tp))(jnp.asarray(pts), jnp.asarray(transforms["H1"]),
                               jnp.asarray(transforms["H2"]),
                               *[jnp.asarray(x) for x in transforms["tps"]])
    tp = ta.view2_to_view1(t(pts), t(transforms["H1"]),
                           t(transforms["H2"]), CFG_T,
                           tuple(t(x) for x in transforms["tps"]))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-3)


def test_make_pair_and_correspondences(transforms):
    """The port's make_pair with the JAX transforms injected (photometric
    off) against the JAX pipeline's pieces; then both correspondence
    generators on the same pair, the full-resolution one with JAX's
    jitter."""
    imgs = _images(4)
    cfg_j = ja.AugConfig(warp_resolution=RES, out_resolution=RES,
                         photometric=False)
    cfg_t = ta.AugConfig(warp_resolution=RES, out_resolution=RES,
                         photometric=False)
    tps_t = tuple(t(x) for x in transforms["tps"])
    pair_t = ta.make_pair(None, t(imgs), cfg_t, transforms={
        "H1": t(transforms["H1"]), "H2": t(transforms["H2"]),
        "tps2": tps_t})
    v1, m1 = jax.vmap(lambda im, h: ja.render_view(im, h, cfg_j))(
        jnp.asarray(imgs), jnp.asarray(transforms["H1"]))
    v2, m2 = jax.vmap(lambda im, h, *tp: ja.render_view(im, h, cfg_j, tp))(
        jnp.asarray(imgs), jnp.asarray(transforms["H2"]),
        *[jnp.asarray(x) for x in transforms["tps"]])
    v1 = jnp.where(m1[..., None], v1, jnp.roll(jnp.asarray(imgs), 1, 0))
    v2 = jnp.where(m2[..., None], v2, jnp.roll(jnp.asarray(imgs), 2, 0))
    np.testing.assert_allclose(pair_t["view1"].numpy(), np.asarray(v1),
                               atol=1e-4)
    np.testing.assert_allclose(pair_t["view2"].numpy(), np.asarray(v2),
                               atol=1e-4)

    pair_j = {**_pair_j(transforms), "mask1": m1, "mask2": m2}
    jc, jm = ja.pair_correspondences(pair_j, cfg_j)
    tc, tm = ta.pair_correspondences(pair_t, cfg_t)
    jc, jm = np.asarray(jc), np.asarray(jm)
    agree = tm.numpy() == jm
    assert agree.mean() > 0.97 and jm.sum() > 10
    both = jm & tm.numpy()
    np.testing.assert_allclose(tc.numpy()[both], jc[both], atol=1e-3)

    key = jax.random.key(7)
    jf, jfm = ja.pair_correspondences_full(pair_j, cfg_j, key)
    jitter = np.asarray(jax.random.uniform(key, (B, 192, 2), minval=0.0,
                                           maxval=8.0))
    tf, tfm = ta.pair_correspondences_full(pair_t, cfg_t, jitter=t(jitter))
    agree = tfm.numpy() == np.asarray(jfm)
    assert agree.mean() > 0.97
    both = np.asarray(jfm) & tfm.numpy()
    np.testing.assert_allclose(tf.numpy()[both], np.asarray(jf)[both],
                               atol=1e-3)


def test_photometric_pieces():
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(B, 24, 32, 3)).astype(np.float32)
    img[0, :4] = 0.5  # a histogram with a tall bin
    np.testing.assert_allclose(
        ta.equalize(t(img)).numpy(),
        np.stack([np.asarray(ja.equalize(jnp.asarray(x))) for x in img]),
        atol=1e-6)
    np.testing.assert_allclose(ta.gaussian_blur7(t(img)).numpy(),
                               np.asarray(ja.gaussian_blur7(
                                   jnp.asarray(img))), atol=1e-6)
    np.testing.assert_allclose(ta.gaussian_blur7(t(img[0])).numpy(),
                               np.asarray(ja.gaussian_blur7(
                                   jnp.asarray(img[0]))), atol=1e-6)
    small = rng.uniform(size=(B, 3, 5, 1)).astype(np.float32)
    for method in ("bilinear", "bicubic"):
        np.testing.assert_allclose(
            ta.resize(t(small), (24, 32), method).numpy(),
            np.asarray(jax.image.resize(jnp.asarray(small), (B, 24, 32, 1),
                                        method)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    out = ta.photometric_augment(g, t(img))
    assert out.shape == img.shape and 0 <= float(out.min()) \
        and float(out.max()) <= 1


@pytest.fixture(scope="module")
def rendered():
    """Two rendered two-view scenes (the port's renderer), as the
    depth-supervised batch the trainer builds."""
    rng = np.random.default_rng(0)
    tex = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
           for _ in range(6)]
    data = {k: [] for k in ("image0", "image1", "depth0", "depth1", "K0",
                            "K1", "T_0to1", "T_1to0")}
    for _ in range(B):
        v = render_scene_views(rng, tex, 2, 64, 48)
        T = v["poses"][1] @ np.linalg.inv(v["poses"][0])
        for i in (0, 1):
            data[f"image{i}"].append(v["images"][i] / 255.0)
            data[f"depth{i}"].append(v["depths"][i])
            data[f"K{i}"].append(v["Ks"][i])
        data["T_0to1"].append(T)
        data["T_1to0"].append(np.linalg.inv(T))
    return {k: np.stack(x).astype(np.float32) for k, x in data.items()}


def test_warp_kpts_and_spvs_coarse_on_rendered_depth(rendered):
    jd = {k: jnp.asarray(v) for k, v in rendered.items()}
    td = {k: t(v) for k, v in rendered.items()}
    kp = np.random.default_rng(1).uniform(0, 48, (B, 40, 2)) \
        .astype(np.float32)
    jv, jp = jw.warp_kpts(jnp.asarray(kp), jd["depth0"], jd["depth1"],
                          jd["T_0to1"], jd["K0"], jd["K1"])
    tv, tp = tw.warp_kpts(t(kp), td["depth0"], td["depth1"], td["T_0to1"],
                          td["K0"], td["K1"])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-3)

    jc, jm = jw.spvs_coarse(jd, 8)
    tc, tm = tw.spvs_coarse(td, 8)
    jm, jc = np.asarray(jm), np.asarray(jc)
    assert jm.sum() > 10
    assert (tm.numpy() == jm).mean() > 0.98
    both = jm & tm.numpy()
    np.testing.assert_allclose(tc.numpy()[both], jc[both], atol=1e-3)

    key = jax.random.key(3)
    jf, jfm = jw.spvs_full(jd, key, 8)
    jitter = np.asarray(jax.random.uniform(key, (B, 48, 2), minval=0.0,
                                           maxval=8.0))
    tf, tfm = tw.spvs_full(td, jitter=t(jitter))
    assert (tfm.numpy() == np.asarray(jfm)).mean() > 0.98
    both = np.asarray(jfm) & tfm.numpy()
    np.testing.assert_allclose(tf.numpy()[both], np.asarray(jf)[both],
                               atol=1e-3)


def test_corr_to_fixed_with_jax_priorities():
    rng = np.random.default_rng(5)
    corrs = rng.normal(size=(B, 30, 4)).astype(np.float32)
    mask = rng.uniform(size=(B, 30)) > 0.5
    for max_corrs in (8, 40):
        jc, jm = jw.corr_to_fixed(jnp.asarray(corrs), jnp.asarray(mask),
                                  max_corrs)
        tc, tm = tw.corr_to_fixed(t(corrs), t(mask), max_corrs)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        key = jax.random.key(max_corrs)
        jc, jm = jw.corr_to_fixed(jnp.asarray(corrs), jnp.asarray(mask),
                                  max_corrs, key=key)
        prio = np.asarray(jax.random.uniform(key, mask.shape))
        tc, tm = tw.corr_to_fixed(t(corrs), t(mask), max_corrs,
                                  priority=t(prio))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
