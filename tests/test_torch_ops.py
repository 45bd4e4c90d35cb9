"""The port's backbone and plain ops against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode) and the port's counterpart; tolerances are stated per
test. The plain versions here are what the CUDA kernels are held against
on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import load_params as jax_load_params
from accelerated_features_tpu.experiments.bicubic_mxu import \
    sample_bicubic_mxu
from accelerated_features_tpu.models.backbone import \
    xfeat_forward as jax_xfeat_forward
from accelerated_features_tpu.ops import detect as jdetect
from accelerated_features_tpu.ops import matching as jmatching
from accelerated_features_tpu.ops import resize as jresize
from accelerated_features_tpu.ops import sample as jsample
from accelerated_features_tpu.ops.extraction import \
    l2_normalize as jax_l2_normalize
from accelerated_features_tpu.ops.pallas.bicubic import (sample_bicubic_fused,
                                                         sample_bicubic_w2)
from accelerated_features_tpu.ops.pallas.detect_fused import \
    topk_keypoints_fused as jax_topk_keypoints_fused
from accelerated_features_tpu.ops.pallas.mnn import \
    mnn_match_fused as jax_mnn_match_fused
from accelerated_features_tpu_torch.models.backbone import xfeat_forward
from accelerated_features_tpu_torch.models.params import load_params
from accelerated_features_tpu_torch.ops import detect, matching, resize, sample
from accelerated_features_tpu_torch.ops.cuda import bicubic as cuda_bicubic
from accelerated_features_tpu_torch.ops.cuda import \
    detect_fused as cuda_detect
from accelerated_features_tpu_torch.ops.cuda import mnn as cuda_mnn

from torch_support import CKPT, t



@pytest.mark.parametrize("hw", [(64, 96), (96, 128)])
def test_xfeat_forward_parity(hw):
    rng = np.random.default_rng(hw[0])
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = jax.jit(jax_xfeat_forward)(jax_load_params(CKPT), jnp.asarray(x))
    got = xfeat_forward(load_params(CKPT), t(x))
    # atol 1e-4; the dustbin logits reach |500|, where one float32 ulp is
    # 6e-5, so a 1e-6 relative term (a few ulps) covers their rounding
    for name, r, g in zip(("feats", "logits", "heat"), ref, got):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("shape,out_hw", [((2, 100, 140, 3), None),
                                          ((1, 37, 53, 1), (64, 80))])
def test_resize_parity(shape, out_hw):
    """Downscaling to /32 of a size not divisible by 32, and an upscale."""
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    if out_hw is None:
        ref, rh, rw = jresize.preprocess_image(jnp.asarray(x))
        got, grh, grw = resize.preprocess_image(t(x))
        assert (rh, rw) == (grh, grw)
    else:
        ref = jresize.resize_bilinear(jnp.asarray(x), out_hw)
        got = resize.resize_bilinear(t(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_to_unit_float_and_preprocess_shape():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_array_equal(resize.to_unit_float(t(x)).numpy(),
                                  np.asarray(jresize.to_unit_float(x)))
    assert resize.preprocess_shape(608, 800) == (608, 800, 1.0, 1.0)
    assert resize.preprocess_shape(100, 140) == jresize.preprocess_shape(100,
                                                                          140)
    with pytest.raises(ValueError):
        resize.preprocess_shape(31, 64)


def _heat_case(seed, b, h, w):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, h, w, 65)) * 3).astype(np.float32)
    rel = rng.uniform(0.1, 1, (b, h, w)).astype(np.float32)
    return logits, rel


def _valid_sorted(kpts, scores):
    """Valid keypoints and their scores, ordered by (y, x)."""
    v = scores > 0
    k, s = kpts[v], scores[v]
    order = np.lexsort((k[:, 0], k[:, 1]))
    return k[order], s[order]


DETECT_CASES = [(3, 2, 8, 16, 96), (5, 2, 10, 76, 128), (11, 2, 4, 4, 64)]


@pytest.mark.parametrize("seed,b,h,w,k", DETECT_CASES)
def test_detect_plain_matches_jax(seed, b, h, w, k):
    """Kernel A's plain version (score_map + topk_keypoints) against the
    JAX package's: identical keypoints and order, scores within 1e-5."""
    logits, rel = _heat_case(seed, b, h, w)
    kheat = jdetect.heatmap_decode(jnp.asarray(logits))
    np.testing.assert_allclose(detect.heatmap_decode(t(logits)).numpy(),
                               np.asarray(kheat), atol=1e-6)
    ref_map = jdetect.score_map(kheat, jnp.asarray(rel), 0.012)
    got_map = detect.score_map(t(np.asarray(kheat)), t(rel), 0.012)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(ref_map),
                               atol=1e-6)
    k_ref, s_ref = map(np.asarray, jdetect.topk_keypoints(ref_map, k))
    k_got, s_got = detect.topk_keypoints(got_map, k)
    k_got, s_got = k_got.numpy(), s_got.numpy()
    assert k_got.dtype == np.int64
    for i in range(b):
        v = s_ref[i] > 0
        np.testing.assert_array_equal(s_got[i] > 0, v)
        np.testing.assert_array_equal(k_got[i][v], k_ref[i][v])
        np.testing.assert_allclose(s_got[i][v], s_ref[i][v], rtol=1e-5)


@pytest.mark.parametrize("seed,b,h,w,k", DETECT_CASES)
def test_detect_plain_matches_pallas_interpret(seed, b, h, w, k):
    """Against the Pallas detect kernel (interpret mode): the same keypoint
    set, scores within 1e-5 absolute (the tolerance of the JAX package's
    own test of that kernel: it places the lerp taps in float64 and drops
    4 mantissa bits of the score)."""
    logits, rel = _heat_case(seed, b, h, w)
    kheat = jdetect.heatmap_decode(jnp.asarray(logits))
    k_ref, s_ref = map(np.asarray, jax_topk_keypoints_fused(
        kheat, jnp.asarray(rel), k, 0.012, interpret=True))
    k_got, s_got = cuda_detect.topk_keypoints_fused(
        t(np.asarray(kheat)), t(rel), k, 0.012)
    for i in range(b):
        kr, sr = _valid_sorted(k_ref[i], s_ref[i])
        kg, sg = _valid_sorted(k_got[i].numpy(), s_got[i].numpy())
        np.testing.assert_array_equal(kg, kr)
        np.testing.assert_allclose(sg, sr, atol=1e-5)


@pytest.mark.parametrize("hw", [(12, 16), (60, 80), (5, 7)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_variants_equal_reshape_and_jax(hw):
    """`heatmap_decode_convt`, `heatmap_decode_planes` and
    `heatmap_decode_auto` on the inputs of the JAX package's variant test
    (tests/test_ops.py): bit for bit the port's reshape form, and within
    1e-6 of the JAX variant of the same name (the softmax rounds
    differently between the packages, as `heatmap_decode`'s parity
    allows)."""
    rng = np.random.default_rng(7)
    for _ in range([(12, 16), (60, 80), (5, 7)].index(hw) + 1):
        logits = rng.normal(0, 2, (2, *hw, 65)).astype(np.float32)
    ref = detect.heatmap_decode(t(logits))
    for impl, fn, jfn in (
            ("reshape", detect.heatmap_decode, jdetect.heatmap_decode),
            ("convt", detect.heatmap_decode_convt,
             jdetect.heatmap_decode_convt),
            ("planes", detect.heatmap_decode_planes,
             jdetect.heatmap_decode_planes)):
        got = fn(t(logits))
        assert torch.equal(got, ref), impl
        assert torch.equal(detect.heatmap_decode_auto(t(logits), impl=impl),
                           ref)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jfn(jnp.asarray(logits))),
                                   atol=1e-6)
    assert torch.equal(detect.heatmap_decode_auto(t(logits), 0.5),
                       detect.heatmap_decode(t(logits), 0.5))


def test_decode_auto_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="convt"):
        detect.heatmap_decode_auto(torch.zeros(1, 2, 2, 65), impl="reshap")


def test_detect_wrapper_on_cpu_runs_plain_and_counts_nothing():
    logits, rel = _heat_case(7, 2, 6, 10)
    kheat = detect.heatmap_decode(t(logits))
    before = cuda_detect.topk_keypoints_fused.launches
    best, sub = detect.tile_candidates(detect.score_map(kheat, t(rel), 0.02))
    assert sub.dtype == torch.uint8 and tuple(best.shape) == (2, 24, 40)
    k1, s1 = cuda_detect.topk_keypoints_fused(kheat, t(rel), 50, 0.02)
    k2, s2 = detect.select_keypoints(best, sub, 50)
    assert torch.equal(k1, k2) and torch.equal(s1, s2)
    assert k1.shape == (2, 50, 2) and k1.dtype == torch.int64
    assert cuda_detect.topk_keypoints_fused.launches == before


def test_topk_ties_follow_index_order():
    """Equal scores come out in index order, as lax.top_k orders them."""
    scores = torch.full((1, 4, 6), -1.0)
    for y, x in [(0, 4), (2, 0), (2, 4), (0, 2)]:
        scores[0, y, x] = 0.5
    kp, s = detect.topk_keypoints(scores, 6)
    k_ref, s_ref = jdetect.topk_keypoints(jnp.asarray(scores.numpy()), 6)
    np.testing.assert_array_equal(kp.numpy()[0, :4], np.asarray(k_ref)[0, :4])
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("n,k", [(300, 64), (50, 50), (20, 32)])
def test_padded_top_k_ties_across_the_kth_place(n, k):
    """Where equal values straddle the k-th place, `lax.top_k` keeps the
    lowest indices among them; `torch.topk` alone promises no such thing.
    Values on a grid of 1/8 (and a -0.0) against the JAX package."""
    rng = np.random.default_rng(n)
    flat = (np.round(rng.uniform(-1, 1, (3, n)) * 8) / 8).astype(np.float32)
    flat[0, 5] = -0.0
    r_vals, r_idx = jdetect._padded_top_k(jnp.asarray(flat), k)
    g_vals, g_idx = detect._padded_top_k(t(flat), k)
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(g_vals.numpy(), np.asarray(r_vals))


def _sample_case(seed, b=2, h=12, w=16, k=300):
    rng = np.random.default_rng(seed)
    H, W = h * 8, w * 8
    maps = rng.normal(size=(b, h, w, 64)).astype(np.float32)
    pos = np.stack([rng.uniform(-8, W + 8, (b, k)),
                    rng.uniform(-8, H + 8, (b, k))], -1).astype(np.float32)
    # integer pixels as on the main path, and the image corners
    pos[:, : k // 2] = np.round(pos[:, : k // 2])
    pos[:, :4] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1]]
    return maps, pos, (H, W)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_samplers_match_jax(mode):
    maps, pos, hw = _sample_case(2)
    ref = getattr(jsample, f"sample_{mode}")(jnp.asarray(maps),
                                             jnp.asarray(pos), hw)
    got = getattr(sample, f"sample_{mode}")(t(maps), t(pos), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _unit_rows(maps):
    return np.asarray(jax_l2_normalize(jnp.asarray(maps)))


@pytest.mark.parametrize("case", ["raw", "zero pixel", "tiny pixel",
                                  "borders"])
def test_bicubic_plain_matches_jax(case):
    """Kernel B's function on the backbone's raw map, through the wrapper
    on the CPU, against the JAX package's sparse path:
    l2_normalize(sample_bicubic(l2_normalize(maps))). Edge cases: an
    all-zero pixel and a pixel whose norm is under 1e-12 (divided by
    1e-12, as F.normalize does) under the taps of some keypoints, and
    keypoints on and past the borders (taps off the map are zero)."""
    maps, pos, hw = _sample_case(3)
    H, W = hw
    if case == "zero pixel":
        maps[:, 3:5, 4:6] = 0.0
        pos[:, 4:20] = [4 * 8 + 4, 3 * 8 + 4] + np.random.default_rng(
            0).uniform(-12, 12, (16, 2))
    elif case == "tiny pixel":
        maps[:, 6, 7] = 1e-14
        maps[:, 6, 8] = 3e-13
        pos[:, 4:20] = [7 * 8 + 4, 6 * 8 + 4] + np.random.default_rng(
            1).uniform(-12, 12, (16, 2))
    elif case == "borders":
        pos[:, 4:] = np.stack(np.meshgrid(
            np.linspace(-20, W + 19, 37), [-3, -0.5, 0, 1, H - 2, H - 1,
                                           H - 0.5, H + 20]), -1
        ).reshape(-1, 2)[:pos.shape[1] - 4]
    ref = jax_l2_normalize(jsample.sample_bicubic(
        jax_l2_normalize(jnp.asarray(maps)), jnp.asarray(pos), hw))
    got = cuda_bicubic.sample_descriptors(t(maps), t(pos), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if case == "borders":  # every tap off the map: the zero descriptor
        h, w = maps.shape[1:3]
        x0 = np.floor(pos[..., 0] * (w / (W - 1)) - 0.5)
        y0 = np.floor(pos[..., 1] * (h / (H - 1)) - 0.5)
        far = (x0 + 2 < 0) | (x0 - 1 >= w) | (y0 + 2 < 0) | (y0 - 1 >= h)
        assert far.any() and not got.numpy()[far].any()


@pytest.mark.parametrize("kernel,atol", [(sample_bicubic_fused, 3e-2),
                                         (sample_bicubic_w2, 6e-3)])
def test_bicubic_plain_matches_pallas_interpret(kernel, atol):
    """Against both Pallas samplers, which read the map in bf16: the
    tolerances of their own tests. They sample an already normalized map,
    as the JAX package's sparse path gives them, so both get unit rows
    (the plain version normalizes them again, at rounding level)."""
    maps, pos, hw = _sample_case(4, h=10, w=13, k=70)
    maps = _unit_rows(maps)
    pos = np.clip(pos, 2, [hw[1] - 3, hw[0] - 3]).astype(np.float32)
    ref = kernel(jnp.asarray(maps), jnp.asarray(pos), hw, interpret=True)
    got = cuda_bicubic.plain_descriptors(t(maps), t(pos), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


@pytest.mark.parametrize("h,w,k", [(60, 80, 512), (10, 13, 70)])
def test_bicubic_plain_matches_mxu_sampler_interpret(h, w, k):
    """The experimental VMEM-resident sampler (`experiments/bicubic_mxu.py`)
    computes the function of kernel B without the L2 norms, in bf16. The
    port's plain sampler agrees with it at the tolerance its own test
    states (`tests/test_bicubic_mxu.py`: atol 0.05, rtol 0.05), and on a
    normalized map, as the sparse path gives it, kernel B's function
    agrees with its samples normalized, so kernel B serves that TPU kernel
    too."""
    rng = np.random.default_rng(h)
    hw = (h * 8, w * 8)
    maps = rng.normal(size=(2, h, w, 64)).astype(np.float32)
    pos = rng.uniform(0, [hw[1] - 1, hw[0] - 1], (2, k, 2)).astype(np.float32)
    pos[:, :4] = [[0, 0], [hw[1] - 1, hw[0] - 1], [hw[1] - 1, 0],
                  [0, hw[0] - 1]]
    ref = sample_bicubic_mxu(jnp.asarray(maps), jnp.asarray(pos), hw,
                             interpret=True)
    got = sample.sample_bicubic(t(maps), t(pos), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.05,
                               rtol=0.05)
    unit = _unit_rows(maps)
    ref_unit = sample_bicubic_mxu(jnp.asarray(unit), jnp.asarray(pos), hw,
                                  interpret=True)
    normed = cuda_bicubic.plain_descriptors(t(unit), t(pos), hw)
    np.testing.assert_allclose(
        normed.numpy(), np.asarray(jax_l2_normalize(ref_unit)), atol=3e-2)


def _desc_case(kind, seed, k1, k2):
    """'real': d2 is a noisy permutation of d1, so best similarities
    straddle the 0.82 gate. 'ties': small integers / 8, so every
    similarity is exact in float32 and equal values are common."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        d1 = rng.integers(-2, 3, (k1, 64)).astype(np.float32) / 8
        d2 = rng.integers(-2, 3, (k2, 64)).astype(np.float32) / 8
    else:
        d1 = rng.normal(size=(k1, 64))
        src = d1[rng.integers(0, k1, k2)]
        d2 = src + rng.normal(size=(k2, 64)) * rng.uniform(0.2, 0.9,
                                                           (k2, 1))
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v1 = rng.uniform(size=k1) > 0.3
    v2 = rng.uniform(size=k2) > 0.3
    return (d1.astype(np.float32), d2.astype(np.float32), v1, v2)


MNN_CASES = [("real", 0.82), ("real", -1.0), ("ties", -1.0), ("ties", 0.82)]


@pytest.mark.parametrize("kind,min_cossim", MNN_CASES)
def test_mnn_plain_matches_jax(kind, min_cossim):
    """Kernel C's plain version against mnn_match: identical idx1, mask."""
    d1, d2, v1, v2 = _desc_case(kind, 0, 200, 170)
    ref_idx, ref_mask = jax.jit(
        lambda a, b, x, y: jmatching.mnn_match(a, b, x, y, min_cossim))(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    idx, mask = matching.mnn_match(t(d1), t(d2), t(v1), t(v2), min_cossim)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    if kind == "real" and min_cossim < 0:
        assert mask.sum() > 20


@pytest.mark.parametrize("kind,min_cossim", MNN_CASES)
def test_mnn_plain_matches_pallas_interpret(kind, min_cossim):
    d1, d2, v1, v2 = _desc_case(kind, 1, 300, 260)
    ref_idx, ref_mask = jax_mnn_match_fused(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        min_cossim=min_cossim, interpret=True)
    idx, mask = cuda_mnn.mnn_match_fused(t(d1), t(d2), t(v1), t(v2),
                                         min_cossim)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("gate,valid2,ties", [
    (-1.0, None, [True, False]),          # row 0: top two 5e-7 apart
    (0.5, None, [True, True]),            # row 1: best on the gate
    (-1.0, [True, False, True], [False, False]),
    (-1.0, [True, False, False], [False, False]),  # -1e9 fill: exact
])
def test_mnn_near_ties(gate, valid2, ties):
    """The near-tie rows that the card's fp32 comparisons of kernel C
    excuse: top two within eps, in float64, the -1e9 fill excluded."""
    a = np.arccos(1 - 5e-7)
    d1 = np.zeros((1, 2, 64))
    d1[0, 0, 0] = d1[0, 1, 1] = 1
    d2 = np.zeros((1, 3, 64))
    d2[0, 0, 0] = 1
    d2[0, 1, :2] = np.cos(a), np.sin(a)
    d2[0, 2, 1] = 0.5
    v2 = None if valid2 is None else t([valid2])
    tie, smax = cuda_mnn.near_ties(t(d1).float(), t(d2).float(), None, v2,
                                   gate, eps=1e-6)
    assert tie[0].tolist() == ties
    assert smax.dtype == torch.float64 and float(smax[0, 0]) == 1.0


def test_batch_mnn_matches_jax_vmap():
    cases = [_desc_case("real", s, 96, 80) for s in range(3)]
    d1, d2, v1, v2 = (np.stack(c) for c in zip(*cases))
    ref_idx, ref_mask = jax.jit(
        lambda a, b, x, y: jmatching.batch_mnn_match(a, b, x, y, 0.5))(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2))
    before = cuda_mnn.batch_mnn_match_fused.launches
    idx, mask = cuda_mnn.batch_mnn_match_fused(t(d1), t(d2), t(v1), t(v2),
                                               0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert cuda_mnn.batch_mnn_match_fused.launches == before


@pytest.mark.parametrize("kernel", ["A topk_exact", "B bicubic",
                                    "D attention", "E stem_fused"])
def test_wrappers_carry_gradients_on_the_cpu(kernel):
    """On CPU tensors each wrapper runs its plain version, which autograd
    records: an input (for the stem: a weight) that requires grad gets a
    finite, non-zero gradient, and nothing is launched. (On CUDA tensors
    the wrappers refuse such inputs: `tests/test_torch_cuda.py`.)"""
    from accelerated_features_tpu_torch.ops.cuda import attention, stem_fused
    wrappers = (cuda_detect.topk_exact, cuda_bicubic.sample_descriptors,
                attention.flash_attention, stem_fused.stem_fused)
    before = [fn.launches for fn in wrappers]
    rng = np.random.default_rng(0)

    def leaf(*shape):
        return t(rng.normal(size=shape).astype(np.float32)).requires_grad_()
    if kernel == "A topk_exact":
        x = leaf(2, 300)
        out = cuda_detect.topk_exact(x, 16)[0]
    elif kernel == "B bicubic":
        x = leaf(1, 6, 8, 64)
        pos = t(rng.uniform(0, 40, (1, 20, 2)).astype(np.float32))
        out = cuda_bicubic.sample_descriptors(x, pos, (48, 64))
    elif kernel == "D attention":
        x = leaf(1, 30, 96)
        out = attention.flash_attention(x, leaf(1, 40, 96), leaf(1, 40, 96))
    else:
        params = load_params(CKPT)
        x = params["block1"][0]["w"].clone().requires_grad_()
        params["block1"][0] = {**params["block1"][0], "w": x}
        out = stem_fused.stem_fused(params, t(rng.normal(
            size=(1, 1, 32, 32)).astype(np.float32)))
    assert out.requires_grad
    (out * t(rng.normal(size=out.shape).astype(np.float32))).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert bool(x.grad.abs().sum() > 0)
    assert [fn.launches for fn in wrappers] == before
