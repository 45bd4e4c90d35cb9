"""The port's stem (the plain version of its fused-stem kernel), its
bfloat16 / fused-stem extractor configuration, the `fused_matching`
option and multi-head attention against the JAX package, on the CPU.

Inputs come from numpy seeds; random folded weights are made by the JAX
package and carried across as numpy. The Pallas stem kernel runs in
interpret mode. Tolerances are stated per test."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import XFeat as JaxXFeat
from accelerated_features_tpu.experiments import stem as jstem
from accelerated_features_tpu.models import backbone as jbackbone
from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.models.params import (fold_batchnorm,
                                                    init_xfeat_params)
from accelerated_features_tpu.ops import extraction as jextraction
from accelerated_features_tpu_torch import XFeat, xfeat_forward
from accelerated_features_tpu_torch.models import lighterglue as lg
from accelerated_features_tpu_torch.models.backbone import XFeatModel
from accelerated_features_tpu_torch.models.params import (
    load_lighterglue_params, load_npz_tree, params_from_jax)
from accelerated_features_tpu_torch.ops import extraction
from accelerated_features_tpu_torch.ops.cuda import stem_fused as stem
from accelerated_features_tpu_torch.ops.matching import batch_mnn_match

from torch_support import CKPT, LG_CKPT



def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def folded():
    """(JAX tree, port tree) of random folded weights, seed 7."""
    jp = fold_batchnorm(init_xfeat_params(jax.random.key(7)))
    return jp, params_from_jax(to_numpy(jp))


@pytest.fixture(scope="module")
def trained():
    """(JAX tree, port tree) of the repository's trained extractor."""
    return JaxXFeat(weights=CKPT).params, XFeat(weights=CKPT,
                                                device="cpu").model.params


def gray(b, h, w, seed=0):
    """Normalized gray input as numpy (B,H,W,1), made by the JAX
    package's `input_norm` from a seeded uniform image."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(0, 1, (b, h, w, 3)), jnp.float32)
    return np.asarray(jbackbone.input_norm(x))


def nchw(a):
    return torch.tensor(np.asarray(a)).permute(0, 3, 1, 2).contiguous()


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def texture(seed, h, w):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (4, 8, 16):
        g = rng.uniform(0, 1, (h // cell + 2, w // cell + 2))
        img += np.kron(g, np.ones((cell, cell)))[:h, :w]
    return (img / 3 * 255).astype(np.uint8)


# ---- (a) the stem ----------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 96), (96, 64), (160, 224), (32, 32)])
def test_stem_reference_matches_jax_f32(folded, hw):
    """The port's plain stem against the JAX package's XLA stem and its
    Pallas kernel in interpret mode, float32, rtol = atol = 2e-4 (the JAX
    package's own gate between those two)."""
    jp, tp = folded
    xg = gray(2, *hw)
    ref = np.asarray(jstem.stem_reference(jp, jnp.asarray(xg)))
    pallas = np.asarray(jstem.stem_fused(jp, jnp.asarray(xg), interpret=True))
    launches = stem.stem_fused.launches
    got = stem.stem_fused(tp, nchw(xg))   # CPU tensor: the plain version
    assert stem.stem_fused.launches == launches
    assert tuple(got.shape) == (2, 24, hw[0] // 4, hw[1] // 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(nhwc(got), pallas, rtol=2e-4, atol=2e-4)
    same = stem.stem_reference(tp, nchw(xg))
    assert torch.equal(got, same)


def test_stem_reference_f32_is_the_unfused_stem(folded):
    """In float32 the plain stem is the conv chain the backbone runs
    unfused: outputs of `xfeat_forward` agree to 1e-5 either way."""
    _, tp = folded
    x = torch.tensor(np.random.default_rng(1).uniform(0, 1, (1, 64, 96, 3)),
                     dtype=torch.float32)
    for a, b in zip(xfeat_forward(tp, x, fused_stem=True),
                    xfeat_forward(tp, x, fused_stem=False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_stem_reference_bf16_by_the_jax_rule(folded):
    """bfloat16: the port's plain stem rounds where the TPU kernel rounds.
    Its deviation from the float32 result, in units of that result's
    standard deviation, is held to the JAX test's rule: no more than
    max(4 x the XLA bf16 stem's deviation, 0.1); the same bound holds
    against the Pallas kernel's own deviation."""
    jp, tp = folded
    xg = gray(2, 96, 128, seed=3)
    f32 = np.asarray(jstem.stem_reference(jp, jnp.asarray(xg)))
    xb = jnp.asarray(xg).astype(jnp.bfloat16)
    xla = np.asarray(jstem.stem_reference(jp, xb).astype(jnp.float32))
    pallas = np.asarray(jstem.stem_fused(jp, xb, interpret=True)
                        .astype(jnp.float32))
    got = stem.stem_reference(tp, nchw(xg).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale = float(f32.std())
    err_port = np.abs(nhwc(got) - f32).max() / scale
    err_xla = np.abs(xla - f32).max() / scale
    err_pallas = np.abs(pallas - f32).max() / scale
    assert err_port < max(4 * err_xla, 0.1), (err_port, err_xla)
    assert err_port < max(4 * err_pallas, 0.1), (err_port, err_pallas)
    # the same rounding points as the Pallas kernel: a few bf16 steps apart
    assert np.abs(nhwc(got) - pallas).max() / scale < 0.1


def test_stem_weights_are_cast_in_one_place(folded):
    _, tp = folded
    layers, (ws, bs) = stem.stem_weights(tp, torch.bfloat16)
    assert all(w.dtype == b.dtype == torch.float32 for w, b in layers)
    for (w, b), p in zip(layers, tp["block1"]):
        assert torch.equal(w, w.to(torch.bfloat16).float())  # bf16 values
        assert torch.equal(b, p["b"])                        # biases exact
    assert torch.equal(ws, (tp["skip1"]["w"] / 16).to(torch.bfloat16).float())
    packed = stem.pack_params(tp, torch.float32)
    assert packed.shape == (stem.N_PARAMS,)
    assert stem.pack_params(tp, torch.float32) is packed       # cached
    assert stem.pack_params(tp, torch.bfloat16) is not packed
    # [ci][dy][dx][co] order, then biases, skip weight / 16, skip bias
    w2 = tp["block1"][1]["w"]                                   # (8,4,3,3)
    assert packed[36 + ((2 * 3 + 1) * 3 + 0) * 8 + 5] == w2[5, 2, 1, 0]
    assert torch.equal(packed[2648:2672], tp["block1"][3]["b"])
    assert torch.equal(packed[2672:2696], tp["skip1"]["w"].reshape(-1) / 16)
    assert torch.equal(packed[2696:], tp["skip1"]["b"])


@pytest.mark.parametrize("case", ["unfolded", "size", "dtype", "shape"])
def test_stem_rejects_what_it_does_not_take(folded, case):
    _, tp = folded
    x = torch.zeros((1, 1, 32, 32))
    if case == "unfolded":
        raw = params_from_jax(to_numpy(init_xfeat_params(jax.random.key(0))))
        with pytest.raises(ValueError, match="folded"):
            stem.stem_fused(raw, x)
        with pytest.raises(ValueError, match="folded"):
            xfeat_forward(raw, torch.zeros((1, 32, 32, 3)), fused_stem=True)
    elif case == "size":
        with pytest.raises(ValueError, match="divisible by 32"):
            stem.stem_fused(tp, torch.zeros((1, 1, 48, 32)))
    elif case == "dtype":
        with pytest.raises(ValueError):
            stem.stem_fused(tp, x.double())
        with pytest.raises(ValueError, match="compute_dtype"):
            xfeat_forward(tp, torch.zeros((1, 32, 32, 3)),
                          compute_dtype=torch.float16)
    else:
        with pytest.raises(ValueError):
            stem.stem_fused(tp, torch.zeros((1, 32, 32, 1)))


# ---- (b) the configuration -------------------------------------------------

def test_xfeat_forward_fused_stem_f32_matches_jax(trained):
    """`xfeat_forward(fused_stem=True)` in both packages (JAX runs its
    Pallas stem in interpret mode): 1e-4 on feats and heat; the keypoint
    logits (which never see the stem) reach |50| on this noise image,
    where a few float32 ulps are 1e-4, so they get 1e-4 + 1e-5 relative."""
    jp, tp = trained
    x = np.random.default_rng(11).uniform(0, 1, (1, 64, 96, 3)) \
        .astype(np.float32)
    ref = jbackbone.xfeat_forward(jp, jnp.asarray(x), fused_stem=True)
    got = xfeat_forward(tp, torch.tensor(x), fused_stem=True)
    for g, r, rtol in zip(got, ref, (0, 1e-5, 0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=rtol)
    model = XFeatModel(tp)
    for a, b in zip(model(torch.tensor(x), fused_stem=True), got):
        assert torch.equal(a, b)


def by_position(out):
    k = np.asarray(out["keypoints"])
    v = np.asarray(out["valid"])
    k, d = k[v], np.asarray(out["descriptors"])[v]
    order = np.lexsort((k[:, 0], k[:, 1]))
    return k[order], d[order]


def test_detect_and_compute_fused_stem_f32_matches_jax(trained):
    """float32 with the fused stem in both packages: identical keypoint
    sets, descriptors within 1e-4."""
    jp, tp = trained
    im = np.stack([texture(0, 96, 128), texture(1, 96, 128)])[..., None] \
        .repeat(3, -1)
    ref = jextraction.detect_and_compute(jp, jnp.asarray(im), 256,
                                         fused_stem=True)
    got = extraction.detect_and_compute(tp, torch.tensor(im), 256,
                                        fused_stem=True)
    for b in range(2):
        rk, rd = by_position({k: np.asarray(v)[b] for k, v in ref.items()})
        gk, gd = by_position({k: v[b].numpy() for k, v in got.items()})
        assert len(rk) > 50
        np.testing.assert_array_equal(gk, rk)
        np.testing.assert_allclose(gd, rd, atol=1e-4)


@pytest.mark.parametrize("fused_stem", [False, True])
def test_bf16_deviation_no_more_than_twice_jax(trained, fused_stem):
    """bfloat16 rounds at other places in the two frameworks, so each
    package is held to its own float32 result: the largest deviation of
    feats and heat (in units of the float32 output's standard deviation)
    and the share of float32 keypoints that the bfloat16 run loses. The
    port's is no more than twice the JAX package's (plus 0.02 for the
    keypoint share, where a handful of keypoints decide)."""
    jp, tp = trained
    im = texture(2, 96, 128)[None, ..., None].repeat(3, -1)
    x = im.astype(np.float32) / 255.0

    def deviations(forward, dac, to_np):
        f32 = [to_np(a) for a in forward(dtype="float32")]
        b16 = [to_np(a) for a in forward(dtype="bfloat16")]
        dev = [np.abs(b - a).max() / a.std() for a, b in zip(f32, b16)]
        k32, _ = by_position(dac(dtype="float32"))
        k16, d16 = by_position(dac(dtype="bfloat16"))
        s32 = {tuple(p) for p in k32.tolist()}
        s16 = {tuple(p) for p in k16.tolist()}
        np.testing.assert_allclose(np.linalg.norm(d16, axis=1), 1, atol=1e-4)
        return dev[0], dev[2], 1 - len(s32 & s16) / len(s32)

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jax_dev = deviations(
        lambda dtype: jbackbone.xfeat_forward(
            jp, jnp.asarray(x), compute_dtype=jdt[dtype],
            fused_stem=fused_stem),
        lambda dtype: {k: np.asarray(v)[0] for k, v in
                       jextraction.detect_and_compute(
                           jp, jnp.asarray(im), 256,
                           compute_dtype=jdt[dtype],
                           fused_stem=fused_stem).items()},
        lambda a: np.asarray(a.astype(jnp.float32)))
    port_dev = deviations(
        lambda dtype: xfeat_forward(tp, torch.tensor(x),
                                    compute_dtype=tdt[dtype],
                                    fused_stem=fused_stem),
        lambda dtype: {k: v[0].numpy() for k, v in
                       extraction.detect_and_compute(
                           tp, torch.tensor(im), 256,
                           compute_dtype=tdt[dtype],
                           fused_stem=fused_stem).items()},
        lambda a: a.float().numpy())
    out = xfeat_forward(tp, torch.tensor(x), compute_dtype=torch.bfloat16,
                        fused_stem=fused_stem)
    assert all(a.dtype == torch.bfloat16 for a in out)
    assert port_dev[0] <= 2 * jax_dev[0], (port_dev, jax_dev)
    assert port_dev[1] <= 2 * jax_dev[1], (port_dev, jax_dev)
    assert port_dev[2] <= 2 * jax_dev[2] + 0.02, (port_dev, jax_dev)


def test_bf16_descriptors_against_jax_bf16():
    """The known difference of the bfloat16 path: the JAX package samples
    descriptors from a bfloat16 map, the port from the float32 cast of
    the backbone's output. On a 192x256 texture at top_k 512 the two
    bfloat16 runs share >= 97% of their keypoints and the descriptors of
    shared keypoints differ by < 0.01 (measured 0.0047; each package's
    bfloat16 descriptors deviate from its own float32 ones by ~0.005)."""
    im = texture(2, 192, 256)
    ref = JaxXFeat(weights=CKPT, top_k=512,
                   compute_dtype="bfloat16").detectAndCompute(im)[0]
    got = XFeat(weights=CKPT, top_k=512, device="cpu",
                compute_dtype="bfloat16").detectAndCompute(im)[0]
    at = {tuple(p): i for i, p in enumerate(ref["keypoints"].tolist())}
    common = [(i, at[tuple(p)]) for i, p in
              enumerate(got["keypoints"].tolist()) if tuple(p) in at]
    assert len(common) >= 0.97 * len(at)
    gi, ri = map(list, zip(*common))
    diff = np.abs(got["descriptors"].numpy()[gi] - ref["descriptors"][ri])
    assert diff.max() < 0.01


def test_api_options_reach_the_pipeline():
    """`XFeat(compute_dtype=..., fused_stem=...)`: float32 + fused stem
    gives the default path's keypoints; bfloat16 returns float32 unit
    descriptors; the dense path takes both options; a wrong dtype name
    raises."""
    im = texture(3, 96, 128)
    base = XFeat(weights=CKPT, top_k=128, device="cpu")
    fused = XFeat(weights=CKPT, top_k=128, device="cpu", fused_stem=True)
    bf16 = XFeat(weights=CKPT, top_k=128, device="cpu",
                 compute_dtype="bfloat16", fused_stem=True)
    a, b, c = (m.detectAndCompute(im)[0] for m in (base, fused, bf16))
    assert torch.equal(a["keypoints"], b["keypoints"])
    np.testing.assert_allclose(b["descriptors"].numpy(),
                               a["descriptors"].numpy(), atol=1e-5)
    assert c["descriptors"].dtype == torch.float32 and len(c["keypoints"]) > 50
    dense = bf16.detectAndComputeDense(im, top_k=64)
    assert dense["descriptors"].dtype == torch.float32
    assert tuple(dense["keypoints"].shape) == (1, 63, 2)
    m0, m1 = bf16.match_xfeat(im, np.roll(im, (8, 16), axis=(0, 1)))
    assert len(m0) > 20
    share = np.mean(np.all(np.abs(m1 - m0 - [16, 8]) <= 1, axis=1))
    assert share > 0.5
    with pytest.raises(ValueError, match="compute_dtype"):
        XFeat(weights=CKPT, device="cpu", compute_dtype="float16")


# ---- (c) fused_matching and multi-head attention ---------------------------

@pytest.mark.parametrize("fused_matching", [None, False, True])
def test_fused_matching_option(fused_matching, monkeypatch):
    """None: the fused kernel on cuda, the plain matcher on the CPU;
    False: the plain matcher; True on the CPU raises. The plain matcher's
    result is the JAX package's."""
    if fused_matching:
        with pytest.raises(ValueError, match="fused_matching"):
            XFeat(weights=CKPT, device="cpu", fused_matching=True)
        return
    tx = XFeat(weights=CKPT, device="cpu", fused_matching=fused_matching)
    assert tx.fused_matching is False
    calls = []
    import accelerated_features_tpu_torch.api as api
    monkeypatch.setattr(api, "batch_mnn_match", lambda *a: (
        calls.append(1) or batch_mnn_match(*a)))
    monkeypatch.setattr(api, "batch_mnn_match_fused", lambda *a: 1 / 0)
    rng = np.random.default_rng(5)
    d1 = rng.normal(size=(2, 90, 64)).astype(np.float32)
    d2 = (d1[:, ::-1] + 0.4 * rng.normal(size=d1.shape)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    jx = JaxXFeat(weights=CKPT, fused_matching=False)
    for (r0, r1), (g0, g1) in zip(jx.batch_match(d1, d2),
                                  tx.batch_match(d1, d2)):
        np.testing.assert_array_equal(g0.numpy(), r0)
        np.testing.assert_array_equal(g1.numpy(), r1)
    g0, g1 = tx.match(d1[0], d2[0])
    r0, r1 = jx.match(d1[0], d2[0])
    np.testing.assert_array_equal(g1.numpy(), r1)
    assert len(calls) == 2


def test_lighterglue_three_heads_matches_jax():
    """The trained matcher's weights run with heads = 3 (head width 32) in
    both packages: 2 layers, ragged masks; log assignment within 1e-4
    where finite, matches0 identical on real rows."""
    tree = load_npz_tree(LG_CKPT)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = load_lighterglue_params(LG_CKPT)
    jp, tp = ({**p, "layers": p["layers"][:2],
               "assignments": p["assignments"][:2]} for p in (jp, tp))
    rng = np.random.default_rng(6)
    m, n = 48, 40
    k0 = rng.uniform(0, [800, 608], (2, m, 2)).astype(np.float32)
    d0 = rng.normal(size=(2, m, 64)).astype(np.float32)
    perm = rng.permutation(m)[:n]
    k1 = (k0[:, perm] + rng.normal(size=(2, n, 2)) * 2).astype(np.float32)
    d1 = (d0[:, perm] + 0.2 * rng.normal(size=(2, n, 64))).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    size = np.tile(np.array([[800, 608]], np.float32), (2, 1))
    mask0 = np.arange(m)[None] < np.array([48, 31])[:, None]
    mask1 = np.arange(n)[None] < np.array([33, 40])[:, None]
    inputs = (k0, k1, d0, d1, size, size, mask0, mask1)
    ref = jax.jit(functools.partial(jlg.lighterglue_forward, heads=3))(
        jp, *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got = lg.lighterglue_forward(tp, *(torch.tensor(a) for a in inputs),
                                     heads=3)
        one = lg.lighterglue_forward(tp, *(torch.tensor(a) for a in inputs),
                                     heads=1)
    ra, ga = np.asarray(ref["log_assignment"]), got["log_assignment"].numpy()
    fin = np.isfinite(ra)
    np.testing.assert_array_equal(np.isneginf(ga), np.isneginf(ra))
    np.testing.assert_allclose(ga[fin], ra[fin], atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(got["matches0"].numpy()[mask0],
                                  np.asarray(ref["matches0"])[mask0])
    # the head count matters: one head gives another assignment
    assert np.abs(one["log_assignment"].numpy()[fin] - ga[fin]).max() > 1e-2
