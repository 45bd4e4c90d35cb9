"""The port's CUDA kernels against their plain torch versions, on the
card, at awkward shapes the main path does not reach (ragged tiles, points
off the map, empty masks). Marked `cuda`; they skip without a GPU. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.models import lighterglue
from accelerated_features_tpu_torch.models.backbone import xfeat_forward
from accelerated_features_tpu_torch.models.params import load_params
from accelerated_features_tpu_torch.ops.cuda import (attention, bicubic,
                                                     detect_fused,
                                                     feature_fusion, mnn,
                                                     stem_fused)
from accelerated_features_tpu_torch.ops.detect import (_padded_top_k,
                                                        dense_topk,
                                                        heatmap_decode,
                                                        score_map,
                                                        topk_keypoints)
from accelerated_features_tpu_torch.ops.extraction import extract_dense
from accelerated_features_tpu_torch.ops.matching import batch_mnn_match

from select_cases import CASES as SELECT_CASES
from torch_support import CKPT, LG_CKPT

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,w,thr", [(1, 5, 9, 0.012), (3, 8, 16, 0.012),
                                       (2, 4, 4, 0.0)])
def test_detect_kernel_matches_plain(dev, b, h, w, thr):
    """Every candidate: at K = N the stage returns each 2x2 tile's best
    score and its position (in xy), equal to the plain version's."""
    rng = np.random.default_rng(h * w)
    logits = torch.tensor(rng.normal(size=(b, h, w, 65)) * 3,
                          dtype=torch.float32)
    kheat = heatmap_decode(logits)
    if thr == 0.0:  # flat regions: every tied pixel is a local max
        kheat = torch.round(kheat * 64) / 64
    rel = torch.tensor(rng.uniform(0.1, 1, (b, h, w)), dtype=torch.float32)
    kheat, rel = kheat.to(dev), rel.to(dev)
    k = (4 * h) * (4 * w)
    ref_xy, ref_s = topk_keypoints(score_map(kheat, rel, thr), k)
    n = detect_fused.topk_keypoints_fused.launches
    xy, s = detect_fused.topk_keypoints_fused(kheat, rel, k, thr)
    assert detect_fused.topk_keypoints_fused.launches == n + 1
    assert torch.equal(xy, ref_xy) and torch.equal(_bits(s), _bits(ref_s))


@pytest.mark.parametrize("b,h,w,thr", [(1, 5, 9, 0.012), (3, 8, 16, 0.012),
                                       (2, 4, 4, 0.0)])
def test_detect_candidates_kernel_matches_plain(dev, b, h, w, thr):
    """Kernel A's candidate entry alone: each 2x2 tile's best score and its
    position, equal to `tile_candidates(score_map(...))` bit for bit."""
    from accelerated_features_tpu_torch.ops.detect import tile_candidates
    rng = np.random.default_rng(h * w + 1)
    kheat = heatmap_decode(torch.tensor(rng.normal(size=(b, h, w, 65)) * 3,
                                        dtype=torch.float32))
    if thr == 0.0:
        kheat = torch.round(kheat * 64) / 64
    rel = torch.tensor(rng.uniform(0.1, 1, (b, h, w)), dtype=torch.float32)
    kheat, rel = kheat.to(dev), rel.to(dev)
    ref = tile_candidates(score_map(kheat, rel, thr))
    n = detect_fused.detect_candidates.launches
    best, sub = detect_fused.detect_candidates(kheat, rel, thr)
    assert detect_fused.detect_candidates.launches == n + 1
    assert torch.equal(_bits(best), _bits(ref[0])) and torch.equal(sub, ref[1])


def _bits(t):
    return t.float().contiguous().view(torch.int32)


def _heat(seed, b, h, w, flat=()):
    """Decoded heatmaps (B,8h,8w) and reliabilities (B,h,w) from seeded
    logits; images listed in `flat` are constant (every pixel ties)."""
    rng = np.random.default_rng(seed)
    logits = torch.tensor(rng.normal(size=(b, h, w, 65)) * 3,
                          dtype=torch.float32)
    for i in flat:
        logits[i] = 0.0
    rel = torch.tensor(rng.uniform(0.1, 1, (b, h, w)), dtype=torch.float32)
    for i in flat:
        rel[i] = 0.5
    return heatmap_decode(logits), rel


@pytest.mark.parametrize("b,h,w,k,thr,flat", [
    (1, 76, 100, 4096, 0.05, ()),        # the main path's shape
    (4, 76, 100, 4096, 0.012, ()),
    (1, 76, 100, None, 0.012, ()),       # k = N
    (1, 8, 8, 4096, 0.012, ()),          # k > N (64x64 image)
    (1, 76, 100, 20000, 0.0, ()),        # sorted across the cluster
    (1, 114, 152, 140000, 0.0, ()),      # sorted in global memory
    (2, 20, 30, 1, 0.012, ()),           # k = 1
    (3, 24, 40, 500, 0.012, (1,)),       # ragged: one flat image
    (2, 16, 16, 300, 0.0, (0, 1)),       # every score equal
])
def test_fused_topk_equals_plain(dev, b, h, w, k, thr, flat):
    """Kernel A's keypoints and scores equal `topk_keypoints(score_map())`
    on all K slots under torch.equal: order, ties and the padded tail."""
    k = k or (4 * h) * (4 * w)   # None: N, the number of 2x2 tiles
    kheat, rel = _heat(h * w + k, b, h, w, flat)
    kheat, rel = kheat.to(dev), rel.to(dev)
    n = detect_fused.topk_keypoints_fused.launches
    xy, s = detect_fused.topk_keypoints_fused(kheat, rel, k, thr)
    assert detect_fused.topk_keypoints_fused.launches == n + 1
    ref_xy, ref_s = topk_keypoints(score_map(kheat, rel, thr), k)
    assert xy.shape == (b, k, 2) and xy.dtype == torch.int64
    assert torch.equal(xy, ref_xy)
    assert torch.equal(_bits(s), _bits(ref_s))


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_topk_exact_equals_padded_top_k(dev, name):
    """Adversarial rows: ties, signed zeros, bin edges, keys that differ
    only in their last 10 bits, k = 1, k = N, k > N, a global-memory sort."""
    values, k = SELECT_CASES[name]
    v = torch.from_numpy(values).to(dev)
    n = detect_fused.topk_exact.launches
    got_v, got_i = detect_fused.topk_exact(v, k)
    assert detect_fused.topk_exact.launches == n + 1
    ref_v, ref_i = _padded_top_k(v, k)
    assert torch.equal(got_i, ref_i)
    assert torch.equal(_bits(got_v), _bits(ref_v))


def test_dense_topk_routes_to_the_kernel(dev):
    """The semi-dense extraction selects its cells with `topk_exact`."""
    rng = np.random.default_rng(2)
    feats = torch.tensor(rng.normal(size=(2, 12740, 64)), dtype=torch.float32,
                         device=dev)
    rel = torch.tensor(rng.uniform(size=(2, 12740)), dtype=torch.float32,
                       device=dev)
    n = detect_fused.topk_exact.launches
    idx, f = dense_topk(feats, rel, 3276, detect_fused.topk_exact)
    assert detect_fused.topk_exact.launches == n + 1
    assert torch.equal(idx, _padded_top_k(rel, 3276)[1])
    assert torch.equal(f, torch.gather(feats, 1,
                                       idx[..., None].expand(-1, -1, 64)))
    params = to_dev(load_params(CKPT), dev)
    images = torch.tensor(rng.uniform(size=(1, 96, 128, 3)),
                          dtype=torch.float32, device=dev)
    n = detect_fused.topk_exact.launches
    extract_dense(params, images, 100)
    assert detect_fused.topk_exact.launches == n + 1


@pytest.mark.parametrize("b,h,w,k", [(1, 10, 13, 70), (2, 76, 100, 33),
                                     (4, 76, 100, 4096), (3, 76, 100, 4093)])
def test_bicubic_kernel_matches_plain(dev, b, h, w, k):
    """Raw maps with an all-zero pixel and a pixel whose norm is under
    1e-12, keypoints on and past the borders; B = 4 at the main path's
    K = 4096, and K that the block's keypoints (8) do not divide."""
    rng = np.random.default_rng(k)
    H, W = h * 8, w * 8
    maps = torch.tensor(rng.normal(size=(b, h, w, 64)), dtype=torch.float32)
    maps[0, 1, 1] = 0.0
    maps[-1, h // 2, w // 2] = 1e-14
    pos = torch.tensor(np.stack([rng.uniform(-9, W + 9, (b, k)),
                                 rng.uniform(-9, H + 9, (b, k))], -1),
                       dtype=torch.float32)
    pos[:, 0] = torch.tensor([W - 1, H - 1], dtype=torch.float32)
    pos[:, 1] = torch.tensor([12.0, 12.0])  # taps on the zero pixel
    pos[:, 2] = torch.tensor([(w // 2) * W / w + 4, (h // 2) * H / h + 4])
    pos[:, 3] = torch.tensor([-40.0, H + 40.0])  # every tap off the map
    n = bicubic.sample_descriptors.launches
    ref = bicubic.plain_descriptors(maps.to(dev), pos.to(dev), (H, W))
    got = bicubic.sample_descriptors(maps.to(dev), pos.to(dev), (H, W))
    assert bicubic.sample_descriptors.launches == n + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    assert not bool(got[:, 3].any())


@pytest.mark.parametrize("k1,k2,gate", [(100, 37, -1.0), (129, 300, 0.2),
                                        (64, 64, 0.82), (4095, 3001, 0.2),
                                        (257, 4100, -1.0), (1, 1, -1.0)])
def test_mnn_kernel_matches_plain(dev, k1, k2, gate):
    # small integers / 8: exact similarities, many ties
    g = torch.Generator().manual_seed(k1 + k2)
    d1 = (torch.randint(-2, 3, (2, k1, 64), generator=g) / 8).float()
    d2 = (torch.randint(-2, 3, (2, k2, 64), generator=g) / 8).float()
    v1 = torch.rand((2, k1), generator=g) > 0.3
    v2 = torch.rand((2, k2), generator=g) > 0.3
    v2[1] = False  # no valid column at all
    args = [t.to(dev) for t in (d1, d2, v1, v2)]
    i_k, m_k = mnn.batch_mnn_match_fused(*args, gate)
    i_p, m_p = batch_mnn_match(*args, gate)
    assert torch.equal(i_k, i_p) and torch.equal(m_k, m_p)


@pytest.mark.parametrize("gate", [0.82, -1.0])
def test_mnn_kernel_matches_plain_on_fp32_descriptors(dev, gate):
    """Unrounded unit descriptors, d2 a noisy permutation of d1: idx1 and
    mask equal the plain version's except at float64 near-ties, and the
    kernel's column is within 1e-6 of each row's best similarity, which a
    TF32 or bf16 similarity would miss."""
    rng = np.random.default_rng(5)
    b, k1, k2 = 2, 1000, 900
    d1 = rng.normal(size=(b, k1, 64))
    d2 = d1[:, rng.integers(0, k1, k2)] + rng.normal(size=(b, k2, 64)) * 0.5
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1 = torch.tensor(rng.uniform(size=(b, k1)) > 0.2, device=dev)
    v2 = torch.tensor(rng.uniform(size=(b, k2)) > 0.2, device=dev)
    d1, d2 = (torch.tensor(d, dtype=torch.float32, device=dev)
              for d in (d1, d2))
    i_k, m_k = mnn.batch_mnn_match_fused(d1, d2, v1, v2, gate)
    i_p, m_p = batch_mnn_match(d1, d2, v1, v2, gate)
    tie, smax = mnn.near_ties(d1, d2, v1, v2, gate, eps=1e-6)
    diff = (i_k != i_p) | (m_k != m_p)
    assert not bool((diff & ~tie).any())
    assert int(tie.sum()) <= tie.numel() // 200
    picked = (d1.double() * torch.gather(
        d2.double(), 1, i_k[..., None].expand(-1, -1, 64))).sum(-1)
    assert float((smax - picked).max()) <= 1e-6
    assert int(m_k.sum()) > 100


@pytest.mark.parametrize("b,k1,k2", [(1, 4095, 3001), (3, 300, 257),
                                     (1, 130, 4200)])
def test_mnn_kernel_at_sizes_off_the_row_panel(dev, b, k1, k2):
    """K1 != K2, neither a multiple of the 128-row panel or the 64-column
    tile, few and many column splits: the fp32 near-tie gate, and exact
    agreement on descriptors rounded to 1/128."""
    rng = np.random.default_rng(k1 + k2)
    d1 = rng.normal(size=(b, k1, 64))
    d2 = d1[:, rng.integers(0, k1, k2)] + rng.normal(size=(b, k2, 64)) * 0.5
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    d1, d2 = (torch.tensor(d, dtype=torch.float32, device=dev)
              for d in (d1, d2))
    v1 = torch.tensor(rng.uniform(size=(b, k1)) > 0.2, device=dev)
    v2 = torch.tensor(rng.uniform(size=(b, k2)) > 0.2, device=dev)
    for va, vb in ((None, None), (v1, v2)):
        i_k, m_k = mnn.batch_mnn_match_fused(d1, d2, va, vb, 0.82)
        i_p, m_p = batch_mnn_match(d1, d2, va, vb, 0.82)
        tie, smax = mnn.near_ties(d1, d2, va, vb, 0.82, eps=1e-6)
        diff = (i_k != i_p) | (m_k != m_p)
        assert not bool((diff & ~tie).any())
        picked = (d1.double() * torch.gather(
            d2.double(), 1, i_k[..., None].expand(-1, -1, 64))).sum(-1)
        assert float((smax - picked)[smax > -1e8].max()) <= 1e-6
        r1, r2 = (torch.round(d * 128) / 128 for d in (d1, d2))
        i_k, m_k = mnn.batch_mnn_match_fused(r1, r2, va, vb, 0.82)
        i_p, m_p = batch_mnn_match(r1, r2, va, vb, 0.82)
        assert torch.equal(i_k, i_p) and torch.equal(m_k, m_p)


ATTN_TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,nq,nk,d,masked", [
    (2, 100, 80, 96, False), (2, 256, 512, 96, True), (2, 300, 300, 64, True),
    (1, 1, 1, 32, False), (3, 65, 129, 32, True), (1, 1000, 2111, 96, True)])
def test_attention_kernel_matches_plain(dev, b, nq, nk, d, masked):
    """Ragged query and key tiles, every head dim the kernel is built for,
    one key split and several."""
    rng = np.random.default_rng(nq + nk)
    q, k, v = (torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                            device=dev) for n in (nq, nk, nk))
    mask = torch.tensor(rng.uniform(size=(b, nk)) > 0.4, device=dev) \
        if masked else None
    n = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v, mask)
    assert attention.flash_attention.launches == n + 1
    ref = attention.attention_reference(q, k, v, mask)
    torch.testing.assert_close(got, ref, **ATTN_TOL)


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("b,nq,nk,tail", [(1, 4096, 4001, 3900),
                                          (2, 1000, 2111, 1500),
                                          (1, 200, 333, 256),
                                          (1, 4096, 4160, 4100)])
def test_attention_kernel_masked_tail_and_ragged_splits(dev, d, b, nq, nk,
                                                        tail):
    """Nk not a multiple of the 64-key tile; every key from `tail` on
    masked, so whole tail tiles are skipped; key ranges that end inside the
    last split (4001 and 4160 keys: 63 and 65 tiles over several splits)."""
    rng = np.random.default_rng(nq + nk + d)
    q, k, v = (torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                            device=dev) for n in (nq, nk, nk))
    mask = torch.tensor(rng.uniform(size=(b, nk)) > 0.1, device=dev)
    mask[:, tail:] = False
    for m in (None, mask):
        got = attention.flash_attention(q, k, v, m)
        ref = attention.attention_reference(q, k, v, m)
        torch.testing.assert_close(got, ref, **ATTN_TOL)


def test_attention_kernel_masked_keys(dev):
    """A batch item with every key masked gets the mean of V; a row whose
    first key tiles are all masked recovers when a real key arrives;
    masked keys with huge values contribute nothing."""
    rng = np.random.default_rng(0)
    b, nq, nk, d = 3, 70, 200, 96
    q, k, v = (torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                            device=dev) for n in (nq, nk, nk))
    mask = torch.ones((b, nk), dtype=torch.bool, device=dev)
    mask[0] = False
    mask[1, :150] = False
    mask[2, 120:] = False
    k[2, 120:] = 100.0
    v[2, 120:] = -50.0
    got = attention.flash_attention(q, k, v, mask)
    ref = attention.attention_reference(q, k, v, mask)
    torch.testing.assert_close(got, ref, **ATTN_TOL)
    torch.testing.assert_close(got[0], v[0].mean(0).expand(nq, d), atol=1e-5,
                               rtol=0)
    base = attention.flash_attention(q[2:], k[2:, :120].contiguous(),
                                     v[2:, :120].contiguous())
    torch.testing.assert_close(got[2:], base, **ATTN_TOL)


@pytest.mark.parametrize("b,nq,nk,d,heads,hole", [
    pytest.param(*case, id="-".join(map(str, case[:5])) + (
        f"-hole{case[5]}" if case[5] is not None else ""))
    for case in [(8, 512, 512, 96, 1, None), (2, 512, 512, 96, 3, None),
                 (1, 300, 4096, 96, 1, None), (3, 65, 129, 64, 1, None),
                 (2, 1, 70, 32, 1, None), (3, 200, 320, 96, 1, 2),
                 (8, 512, 512, 96, 3, None), (2, 333, 461, 64, 1, None)]])
def test_attention_backward_kernel(dev, b, nq, nk, d, heads, hole):
    """The backward kernel's dq, dk, dv against float64 autograd of
    `attention_reference` and against its plain version on the card, with
    ragged masks, one item whose keys are all masked and three heads of
    width 32 folded into the batch; two runs are bit-equal. Gate: atol 1e-4
    + rtol 1e-3 of float64 (float32 kernels on float32 inputs), and the
    plain version the same way. `hole`: key tile (64 keys) `hole` of every
    item but the first is all masked, between unmasked tiles, so the kernel
    skips it (its dk and dv are 0). Three heads at B = 8, N = 512 give more
    blocks than the card has SMs; Nq != Nk leaves both edges ragged."""
    rng = np.random.default_rng(nq + nk + d)
    bh, hd = b * heads, d // heads
    q, k, v, g = (torch.tensor(rng.normal(size=(bh, n, hd)),
                               dtype=torch.float32, device=dev)
                  for n in (nq, nk, nk, nq))
    keep = rng.uniform(size=(b, nk)) > 0.2
    if hole is None:
        keep[:, rng.integers(1, nk + 1):] = False
    else:
        keep[:, 64 * hole:64 * (hole + 1)] = False
        assert keep[1:, :64 * hole].any(-1).all() \
            and keep[1:, 64 * (hole + 1):].any(-1).all()
    keep[0] = False
    mask = torch.tensor(keep, device=dev).repeat_interleave(heads, 0)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    n = attention.attention_backward.launches
    out = attention.flash_attention(qs, ks, vs, mask)
    out.backward(g)
    assert attention.attention_backward.launches == n + 1
    got = (qs.grad, ks.grad, vs.grad)

    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    attention.attention_reference(q64, k64, v64, mask).backward(g.double())
    _, lse = attention.attention_reference_lse(q, k, v, mask, hd ** -0.5)
    plain = attention.attention_backward_reference(
        q, k, v, mask, out.detach(), lse, g, hd ** -0.5)
    for name, x, ref, p in zip("qkv", got, (q64.grad, k64.grad, v64.grad),
                               plain):
        torch.testing.assert_close(x.double(), ref, atol=1e-4, rtol=1e-3,
                                   msg=f"d{name} against float64")
        torch.testing.assert_close(x, p, atol=1e-4, rtol=1e-3,
                                   msg=f"d{name} against the plain version")
    # the fully masked item: dv gets dO/Nk of each row, dq nothing
    torch.testing.assert_close(got[2][0], g[0].sum(0).expand(nk, hd) / nk,
                               atol=1e-5, rtol=1e-5)
    assert not got[0][0].any() and not got[1][0].any()
    again = attention.attention_backward(q, k, v, mask, out.detach(),
                                         attention._forward(
                                             q, k, v, mask, hd ** -0.5,
                                             True)[1], g, hd ** -0.5)
    first = attention.attention_backward(q, k, v, mask, out.detach(),
                                         attention._forward(
                                             q, k, v, mask, hd ** -0.5,
                                             True)[1], g, hd ** -0.5)
    for a, c in zip(again, first):
        assert torch.equal(a, c)
    if hole is not None:
        rows = slice(64 * hole, 64 * (hole + 1))
        assert not got[1][heads:, rows].any() and not got[2][heads:, rows].any()


@pytest.mark.parametrize("name", ["o", "dout"])
def test_attention_backward_refuses_misaligned_o_and_dout(dev, name):
    """The kernel reads o and dout 16 bytes at a time: a contiguous view
    that starts 4 bytes into its storage is refused with a ValueError."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.tensor(rng.normal(size=(1, 70, 32)),
                               dtype=torch.float32, device=dev)
                  for _ in range(4))
    o, lse = attention._forward(q, k, v, None, 32 ** -0.5, True)
    args = {"o": o, "dout": g}
    flat = torch.empty(args[name].numel() + 1, dtype=torch.float32,
                       device=dev)
    shifted = flat[1:].view(args[name].shape)
    shifted.copy_(args[name])
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    args[name] = shifted
    n = attention.attention_backward.launches
    with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
        attention.attention_backward(q, k, v, None, args["o"], lse,
                                     args["dout"], 32 ** -0.5)
    assert attention.attention_backward.launches == n


def test_lighterglue_attention_routes_to_the_kernel(dev):
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(1, 50, 96)),
                            dtype=torch.float32, device=dev) for _ in range(3))
    n = attention.flash_attention.launches
    got = lighterglue._attention(q, k, v, None, heads=1)
    assert attention.flash_attention.launches == n + 1
    torch.testing.assert_close(got, attention.attention_reference(q, k, v),
                               **ATTN_TOL)


@pytest.mark.parametrize("heads,masked", [(3, True), (3, False), (1, True)])
def test_multi_head_attention_runs_the_kernel(dev, heads, masked):
    """Heads folded into the batch: one launch of kernel D on
    (B*heads, N, 96/heads), against the plain version computed per head
    on the CPU."""
    rng = np.random.default_rng(heads)
    q, k, v = (torch.tensor(rng.normal(size=(2, n, 96)), dtype=torch.float32)
               for n in (150, 200, 200))
    mask = torch.tensor(rng.uniform(size=(2, 200)) > 0.3) if masked else None
    ref = lighterglue._attention(q, k, v, mask, heads=heads)
    n = attention.flash_attention.launches
    got = lighterglue._attention(q.to(dev), k.to(dev), v.to(dev),
                                 None if mask is None else mask.to(dev),
                                 heads=heads)
    assert attention.flash_attention.launches == n + 1
    torch.testing.assert_close(got.cpu(), ref, **ATTN_TOL)
    with pytest.raises(ValueError):  # head width 48: not built
        lighterglue._attention(q.to(dev), k.to(dev), v.to(dev), None, heads=2)


def _attn_inputs(rng, b, nq, nk, d):
    return (torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32,
                         device="cuda") for n in (nq, nk, nk))


def test_attention_kernel_at_lightglue_shape(dev):
    """LightGlue's call: 8 pairs x 4 heads of 64 folded into 32 items of
    4096 x 4096 (one launch, no key split). Item 0 is ragged at 4001
    keys, items 1-3 mask every key from 3500 on (whole tail tiles skipped),
    the rest a tenth of their keys at random; then the same call with
    Nk = 4001 keys (a partial last tile). Held to the plain version; reruns
    are bit-equal."""
    rng = np.random.default_rng(24)
    q, k, v = _attn_inputs(rng, 32, 4096, 4096, 64)
    mask = torch.tensor(rng.uniform(size=(32, 4096)) > 0.1, device=dev)
    mask[0, 4001:] = False
    mask[1:4, 3500:] = False
    ref = attention.attention_reference(q, k, v, mask)
    launches = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v, mask)
    assert attention.flash_attention.launches == launches + 1
    torch.testing.assert_close(got, ref, **ATTN_TOL)
    assert torch.equal(got, attention.flash_attention(q, k, v, mask))
    kr, vr = k[:, :4001].contiguous(), v[:, :4001].contiguous()
    mr = mask[:, :4001].contiguous()
    for m in (None, mr):
        torch.testing.assert_close(attention.flash_attention(q, kr, vr, m),
                                   attention.attention_reference(q, kr, vr, m),
                                   **ATTN_TOL)


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("b,nq,nk", [(3, 300, 700), (1, 4096, 4096)])
def test_attention_kernel_item_with_every_key_masked(dev, d, b, nq, nk):
    """An item whose keys are all masked gets the mean of V over its Nk
    keys, at every width and with one split and several (B = 1, 4096 keys:
    the single pair's split grid); the other items are unharmed."""
    rng = np.random.default_rng(d + nk)
    q, k, v = _attn_inputs(rng, b, nq, nk, d)
    mask = torch.tensor(rng.uniform(size=(b, nk)) > 0.3, device=dev)
    mask[0] = False
    got = attention.flash_attention(q, k, v, mask)
    torch.testing.assert_close(got[0], v[0].mean(0).expand(nq, d),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(got, attention.attention_reference(q, k, v,
                                                                  mask),
                               **ATTN_TOL)


@pytest.mark.parametrize("d", [32, 64])
def test_attention_lse_feeds_the_backward(dev, d):
    """The forward kernel's row log-sum-exp against
    `attention_reference_lse` (one split and a split grid), then the
    backward kernel fed from it against float64 autograd."""
    rng = np.random.default_rng(d)
    scale = d ** -0.5
    for b, nq, nk in ((6, 512, 700), (1, 2048, 3000)):
        q, k, v = _attn_inputs(rng, b, nq, nk, d)
        mask = torch.tensor(rng.uniform(size=(b, nk)) > 0.2, device=dev)
        mask[0, nk // 2:] = False
        out, lse = attention._forward(q, k, v, mask, scale, want_lse=True)
        ref, ref_lse = attention.attention_reference_lse(q, k, v, mask,
                                                         scale)
        torch.testing.assert_close(out, ref, **ATTN_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=1e-5)
        g = torch.tensor(rng.normal(size=(b, nq, d)), dtype=torch.float32,
                         device=dev)
        grads = attention.attention_backward(q, k, v, mask, out, lse, g,
                                             scale)
        q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
        attention.attention_reference(q64, k64, v64, mask,
                                      scale).backward(g.double())
        for name, x, want in zip("qkv", grads, (q64.grad, k64.grad,
                                                v64.grad)):
            torch.testing.assert_close(x.double(), want, atol=1e-4,
                                       rtol=1e-3, msg=f"d{name}")


@pytest.mark.parametrize("d", [32, 64, 96])
def test_attention_kernel_names(dev, d):
    """At every width a call launches `attn_partial_kernel`, and a split
    grid (one pair of 2048 points) also `attn_merge_kernel`: the names the
    benchmark's `attention_roofline` reads
    (`attn_partial_kernel|attn_merge_kernel`)."""
    rng = np.random.default_rng(d)
    q, k, v = _attn_inputs(rng, 1, 2048, 2048, d)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert attention.key_splits(1, 2048, 2048, sms) > 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
    kernels = {e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "attn" in e.name}
    assert any(n.startswith("void attn_partial_kernel<") for n in kernels)
    assert any("attn_merge_kernel" in n for n in kernels)
    assert all("attn_partial_kernel" in n or "attn_merge_kernel" in n
               for n in kernels)


def stem_params(seed):
    """Random folded block1 + skip weights from a numpy seed."""
    rng = np.random.default_rng(seed)
    chans = [(1, 4), (4, 8), (8, 8), (8, 24)]
    block1 = [{"w": torch.tensor(rng.normal(size=(co, ci, 3, 3))
                                 * (2.0 / (9 * ci)) ** 0.5,
                                 dtype=torch.float32),
               "b": torch.tensor(rng.normal(size=co) * 0.3,
                                 dtype=torch.float32)} for ci, co in chans]
    skip = {"w": torch.tensor(rng.normal(size=(24, 1, 1, 1)),
                              dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=24) * 0.3, dtype=torch.float32)}
    return {"block1": block1, "skip1": skip}


def to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, dev) for v in tree]
    return tree.to(dev)


# the /4 output against the 16x16 tile: 152x200, 24x16, 40x56, 8x8 (part
# of one tile), 16x24, 8x40 (one tile row), 56x24
STEM_SHAPES = [(1, 608, 800), (4, 608, 800), (2, 96, 64), (2, 160, 224),
               (3, 32, 32), (1, 64, 96), (2, 32, 160), (1, 224, 96)]


@pytest.mark.parametrize("b,h,w", STEM_SHAPES)
def test_stem_kernel_matches_plain_f32(dev, b, h, w):
    """Tiles that do not divide the /4 output, one-tile images, batches;
    the JAX package's float32 gate for its stem kernel."""
    params = to_dev(stem_params(h + w), dev)
    xg = torch.tensor(np.random.default_rng(b).normal(size=(b, 1, h, w)),
                      dtype=torch.float32, device=dev)
    n = stem_fused.stem_fused.launches
    got = stem_fused.stem_fused(params, xg)
    assert stem_fused.stem_fused.launches == n + 1
    ref = stem_fused.stem_reference(params, xg)
    assert got.shape == ref.shape == (b, 24, h // 4, w // 4)
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,h,w", STEM_SHAPES)
def test_stem_kernel_matches_plain_bf16(dev, b, h, w):
    """bfloat16: the kernel's deviation from the float32 result is no more
    than max(4 x the plain bfloat16 version's, 0.1), in units of the
    float32 output's standard deviation (the JAX package's rule)."""
    params = to_dev(stem_params(h + w), dev)
    xg = torch.tensor(np.random.default_rng(b).normal(size=(b, 1, h, w)),
                      dtype=torch.float32, device=dev).to(torch.bfloat16)
    f32 = stem_fused.stem_reference(params, xg.float())
    got = stem_fused.stem_fused(params, xg)
    ref = stem_fused.stem_reference(params, xg)
    assert got.dtype == torch.bfloat16
    scale = f32.std()
    err_k = float((got.float() - f32).abs().max() / scale)
    err_p = float((ref.float() - f32).abs().max() / scale)
    assert err_k < max(4 * err_p, 0.1), (err_k, err_p)


def test_backbone_routes_to_the_stem_kernel(dev):
    params = to_dev(load_params(CKPT), dev)
    x = torch.tensor(np.random.default_rng(0).uniform(size=(2, 96, 128, 3)),
                     dtype=torch.float32, device=dev)
    n = stem_fused.stem_fused.launches
    fused = xfeat_forward(params, x, fused_stem=True)
    assert stem_fused.stem_fused.launches == n + 1
    plain = xfeat_forward(params, x)
    assert stem_fused.stem_fused.launches == n + 1
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    xfeat_forward(params, x, compute_dtype=torch.bfloat16, fused_stem=True)
    assert stem_fused.stem_fused.launches == n + 2


def _pyramid(dev, b, h, w, seed=0):
    """block3, block4 and block5 outputs of an (h, w) image on the card:
    ReLU'd seeded normals at /8, /16 and /32, so about half are exact
    zeros, as the backbone's are."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.relu(torch.randn((b, 64, h // s, w // s), generator=gen,
                                   device=dev)) for s in (8, 16, 32)]


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("h,w", [(608, 800), (480, 640), (32, 32)])
def test_fusion_kernel_matches_plain(dev, b, h, w):
    """Kernel F against the backbone's plain expression. The kernel writes
    the plain version's arithmetic in its order, (x3 + up4) + up5, but
    the compiler may contract the interpolation's products into FMAs
    otherwise than in PyTorch's bilinear kernel; each such difference is a
    rounding of a sum of nonnegative terms, so the results may differ by a
    few ulp of the value itself: held to 2 ulp of each value's magnitude
    (32x32: block5 is a single pixel)."""
    x3, x4, x5 = _pyramid(dev, b, h, w, seed=b + h)
    n = feature_fusion.fuse_pyramid.launches
    got = feature_fusion.fuse_pyramid(x3, x4, x5)
    assert feature_fusion.fuse_pyramid.launches == n + 1
    ref = feature_fusion.fuse_pyramid_reference(x3, x4, x5)
    assert got.shape == ref.shape == (b, 64, h // 8, w // 8)
    assert got.is_contiguous()
    mag = ref.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    assert bool(((got - ref).abs() <= 2 * ulp).all()), \
        float(((got - ref).abs() / ulp).max())


def test_backbone_routes_to_the_fusion_kernel(dev):
    """Float32 inference launches kernel F once a call; training, weights
    that autograd records and bfloat16 take the plain expression; sides
    not divisible by 32 (80x112: block3 10x14, block4 5x7, block5 3x4)
    are refused."""
    params = to_dev(load_params(CKPT), dev)
    x = torch.tensor(np.random.default_rng(0).uniform(size=(2, 96, 128, 3)),
                     dtype=torch.float32, device=dev)
    launches = feature_fusion.fuse_pyramid
    n = launches.launches
    with torch.no_grad():
        got = xfeat_forward(params, x)
    assert launches.launches == n + 1
    xfeat_forward(params, x)  # grad mode on, nothing requires grad
    assert launches.launches == n + 2
    with pytest.raises(ValueError), torch.no_grad():
        xfeat_forward(params, x[:, :80, :112].contiguous())
    xfeat_forward(params, x, compute_dtype=torch.bfloat16)
    unfolded = to_dev(load_params(CKPT, fold_bn=False), dev)
    xfeat_forward(unfolded, x, train=True)
    graded = {**params, "block3": [{**p, "w": p["w"].clone()
                                    .requires_grad_(True)}
                                   for p in params["block3"]]}
    plain = xfeat_forward(graded, x)
    plain[0].sum().backward()
    assert graded["block3"][0]["w"].grad is not None
    assert launches.launches == n + 2
    for a, b in zip(got, plain):  # the same convs on the card
        torch.testing.assert_close(a, b.detach(), atol=1e-4, rtol=1e-5)


def test_kernels_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        attention.flash_attention(torch.zeros(1, 4, 128, device=dev),
                                  torch.zeros(1, 4, 128, device=dev),
                                  torch.zeros(1, 4, 128, device=dev))
    with pytest.raises(ValueError):
        attention.flash_attention(torch.zeros(1, 4, 96, device=dev),
                                  torch.zeros(1, 5, 96, device=dev),
                                  torch.zeros(1, 6, 96, device=dev))
    with pytest.raises(ValueError):
        detect_fused.topk_keypoints_fused(torch.zeros(1, 7, 8, device=dev),
                                          torch.zeros(1, 1, 1, device=dev),
                                          16)
    with pytest.raises(ValueError):
        bicubic.sample_descriptors(torch.zeros(1, 2, 2, 32, device=dev),
                                   torch.zeros(1, 3, 2, device=dev), (16, 16))
    with pytest.raises(ValueError):  # H not divisible by 32
        stem_fused.stem_fused(to_dev(stem_params(0), dev),
                              torch.zeros(1, 1, 48, 64, device=dev))
    with pytest.raises(ValueError):  # weights on another device
        stem_fused.stem_fused(stem_params(0),
                              torch.zeros(1, 1, 32, 32, device=dev))
    with pytest.raises(ValueError):
        d2 = torch.zeros(1, 64, 4, device=dev).transpose(1, 2)  # strided
        mnn.batch_mnn_match_fused(torch.zeros(1, 4, 64, device=dev), d2)
    x3, x4, x5 = _pyramid(dev, 1, 64, 64)
    with pytest.raises(ValueError):  # float64 on the card
        feature_fusion.fuse_pyramid(x3.double(), x4.double(), x5.double())
    with pytest.raises(ValueError):  # block5 at 1/2, not 1/4
        feature_fusion.fuse_pyramid(x3, x4, x4)


def _guard_cases(dev):
    """{kernel: (call, its inputs)}: one call of each wrapper at a small
    shape; the inputs are the tensors a caller could mark."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)
    kheat, rel = heatmap_decode(t(1, 4, 6, 65).cpu()).to(dev), t(1, 4, 6)
    cells, maps, pos = t(2, 300), t(1, 6, 8, 64), t(1, 20, 2).abs() * 20
    d1, d2 = t(1, 40, 64), t(1, 50, 64)
    params = to_dev(stem_params(3), dev)
    xg = t(1, 1, 32, 32)
    return {
        "A detect_fused": (lambda a, b: detect_fused.topk_keypoints_fused(
            a, b, 16, 0.0), [kheat, rel]),
        "A topk_exact": (lambda a: detect_fused.topk_exact(a, 16), [cells]),
        "B bicubic": (lambda a, b: bicubic.sample_descriptors(
            a, b, (48, 64)), [maps, pos]),
        "C mnn": (mnn.batch_mnn_match_fused, [d1, d2]),
        "E stem_fused": (lambda w, x: stem_fused.stem_fused(
            {**params, "block1": [{**params["block1"][0], "w": w},
                                  *params["block1"][1:]]}, x),
                         [params["block1"][0]["w"], xg]),
        "F feature_fusion": (feature_fusion.fuse_pyramid,
                             _pyramid(dev, 1, 32, 64)),
    }


@pytest.mark.parametrize("kernel", ["A detect_fused", "A topk_exact",
                                    "B bicubic", "C mnn", "E stem_fused",
                                    "F feature_fusion"])
def test_kernels_refuse_inputs_that_require_grad(dev, kernel):
    """With grad mode on, an input (for the stem: a weight) that requires
    grad makes the wrapper raise before it launches; under no_grad the
    same call runs the kernel. Kernel D is not among them: it has a
    backward kernel (`test_attention_backward_kernel`)."""
    call, inputs = _guard_cases(dev)[kernel]
    for i in range(len(inputs)):
        marked = [x.clone().requires_grad_(j == i)
                  for j, x in enumerate(inputs)]
        with pytest.raises(RuntimeError, match="no backward"):
            call(*marked)
        with torch.no_grad():
            call(*marked)
    call(*inputs)  # nothing requires grad: runs with grad mode on


def test_matmuls_ignore_the_tf32_flag(dev):
    """With `torch.backends.cuda.matmul.allow_tf32` turned on by the
    caller, the plain MNN, `match_lighterglue`'s matches0 and
    `match_xfeat_star`'s matches equal the results with it off, and the
    caller's flag reads True again after each call."""
    from accelerated_features_tpu_torch import XFeat
    from accelerated_features_tpu_torch.models.lighterglue import LighterGlue
    rng = np.random.default_rng(7)
    d = rng.normal(size=(2, 2, 3000, 64))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d1, d2 = (torch.tensor(x, dtype=torch.float32, device=dev) for x in d)
    xf = XFeat(CKPT, top_k=2048, device=dev)
    lg = LighterGlue(LG_CKPT, dev)
    img = (rng.uniform(size=(256, 320)) * 255).astype(np.uint8)
    img = np.kron(img[::4, ::4], np.ones((4, 4), np.uint8))
    f0 = {**xf.detectAndCompute(img)[0], "image_size": (320, 256)}
    f1 = {**xf.detectAndCompute(np.roll(img, 8, 1))[0],
          "image_size": (320, 256)}

    def run():
        return (batch_mnn_match(d1, d2),
                lg.forward_padded(f0, f1)["matches0"],
                xf.match_xfeat_star(img, np.roll(img, 8, 1)))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        on = run()
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(on[0][0], off[0][0]) and torch.equal(on[0][1],
                                                            off[0][1])
    assert torch.equal(on[1], off[1])
    assert len(off[2][0]) > 0
    for a, b in zip(on[2], off[2]):
        np.testing.assert_array_equal(a, b)


def _ba_problem(dev, seed=0, n_cams=6, n_pts=300):
    """A seeded BA problem on `dev`: cameras on an arc around a point cloud,
    1 px noise, a perturbed start, cameras 0 and 1 frozen (no free
    gauge)."""
    from accelerated_features_tpu_torch.sfm import BAProblem, project
    rng = np.random.default_rng(seed)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = torch.tensor(rng.uniform([-2, -2, 6], [2, 2, 10], (n_pts, 3)),
                     dtype=torch.float32)
    cams = torch.zeros((n_cams, 6))
    cams[:, 1] = 0.1 * (torch.arange(n_cams) - n_cams / 2)
    cams[:, 3] = 0.5 * (torch.arange(n_cams) - n_cams / 2)
    oc = torch.arange(n_cams).repeat_interleave(n_pts)
    op = torch.arange(n_pts).repeat(n_cams)
    uv = project(cams[oc], X[op], K)
    uv = uv + torch.tensor(rng.normal(0, 1.0, tuple(uv.shape)),
                           dtype=torch.float32)
    start = cams + torch.tensor(rng.normal(0, 0.05, (n_cams, 6)),
                                dtype=torch.float32)
    start[:2] = cams[:2]
    fixed = torch.zeros(n_cams, dtype=torch.bool)
    fixed[:2] = True
    return BAProblem(
        cams=start, points=X + torch.tensor(
            rng.normal(0, 0.1, (n_pts, 3)), dtype=torch.float32),
        K=K, obs_cam=oc, obs_pt=op, obs_uv=uv,
        obs_mask=torch.ones(len(oc), dtype=torch.bool),
        fixed_cams=fixed).to(dev)


def _ring(n=10):
    """A pose graph: keyframes on a circle, noisy starts, odometry edges
    and one loop edge."""
    from accelerated_features_tpu_torch.sfm import (PoseGraph, se3_compose,
                                                    se3_inverse)
    rng = np.random.default_rng(6)
    th = torch.linspace(0, 1.6 * np.pi, n)
    gt = torch.zeros((n, 6))
    gt[:, 1] = -th
    gt[:, 3] = 3 * torch.sin(th)
    gt[:, 5] = 3 * (torch.cos(th) - 1)
    g = PoseGraph.empty()
    for i in range(n):
        noise = 0 if i == 0 else rng.normal(0, 0.03, 6)
        g.add_keyframe(gt[i].numpy() + noise)
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]:
        g.add_edge(i, j, se3_compose(gt[j], se3_inverse(gt[i])).numpy())
    return g


def test_ba_and_pose_graph_ignore_the_tf32_flag(dev):
    """With `allow_tf32` turned on by the caller, `bundle_adjust` and
    `optimize_pose_graph` give, bit for bit, their results with it off
    (TF32 products would move them by ~1e-3 relative), and the flag reads
    True after."""
    from accelerated_features_tpu_torch.sfm import (bundle_adjust,
                                                    optimize_pose_graph)
    p = _ba_problem(dev)
    g = _ring()
    prev = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            solved, info = bundle_adjust(p, iters=8, cg_iters=25)
            out[flag] = (solved.cams.cpu(), info["final_cost"].cpu(),
                         optimize_pose_graph(g, device=dev)[0])
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (c0, cost0, g0), (c1, cost1, g1) = out[False], out[True]
    assert torch.equal(c1, c0) and torch.equal(cost1, cost0)
    assert np.array_equal(g1, g0)


def test_bundle_adjust_is_deterministic_on_the_card(dev):
    """Two solves of one problem are equal bit for bit: the segment sums
    gather through fixed tables instead of adding through atomics."""
    from accelerated_features_tpu_torch.sfm import bundle_adjust
    p = _ba_problem(dev)
    a, ia = bundle_adjust(p, iters=6, cg_iters=25)
    b, ib = bundle_adjust(p, iters=6, cg_iters=25)
    assert torch.equal(a.cams, b.cams) and torch.equal(a.points, b.points)
    assert torch.equal(ia["final_cost"], ib["final_cost"])


def test_bundle_adjust_reads_back_once(dev):
    """The LM and CG loops read nothing back: under the sync debug mode
    the whole solve synchronizes once, when `segment_tables` reads its two
    table widths."""
    import warnings

    from accelerated_features_tpu_torch.sfm import bundle_adjust
    p = _ba_problem(dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solved, info = bundle_adjust(p, iters=4, cg_iters=10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert float(info["final_cost"]) < float(info["initial_cost"])


def test_bundle_adjust_on_the_card_matches_the_cpu(dev):
    """The same problem on the card and on the CPU: the final cost within
    1e-4, the cameras within 1e-4 of their largest value (the gauge is
    fixed, so the solution is unique)."""
    from accelerated_features_tpu_torch.sfm import (bundle_adjust,
                                                    reprojection_rmse)
    p = _ba_problem(dev)
    got, ginfo = bundle_adjust(p, iters=10, cg_iters=30)
    want, winfo = bundle_adjust(p.to("cpu"), iters=10, cg_iters=30)
    assert float(ginfo["final_cost"]) == pytest.approx(
        float(winfo["final_cost"]), rel=1e-4)
    assert (got.cams.cpu() - want.cams).abs().max() <= \
        1e-4 * want.cams.abs().max()
    assert float(reprojection_rmse(got)) < 1.5


def test_server_on_the_card_answers_like_direct_calls(dev):
    """The port's HTTP server on `cuda` (its default device) with the
    trained extractor: /detect of two images released together (one batch)
    and /match?mode=mnn equal, under np.array_equal, to direct calls on the
    same XFeat (detectAndCompute of the batch the server ran; match_xfeat);
    kernels A and B ran once for the batch, C for the match."""
    import io
    import threading
    import urllib.request

    from accelerated_features_tpu_torch.apps.serve import serve
    from accelerated_features_tpu_torch.ops.cuda.detect_fused import \
        topk_keypoints_fused

    httpd = serve(port=0, weights=CKPT, top_k=512, max_batch=2,
                  max_wait_ms=2000.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    xf = httpd.service.xfeat
    port = httpd.server_address[1]
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
            for _ in range(2)]

    def post(path, **arrays):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return np.load(io.BytesIO(r.read()))

    batches, real = [], type(xf).detectAndCompute

    def recorded(x, *a, **kw):
        batches.append(x.clone())
        return real(xf, x, *a, **kw)

    try:
        xf.detectAndCompute = recorded
        results = [None, None]
        n = topk_keypoints_fused.launches
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, post("/detect",
                                                           image=imgs[i])))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert [tuple(b.shape) for b in batches] == [(2, 240, 320, 3)]
        assert topk_keypoints_fused.launches == n + 1
        del xf.detectAndCompute
        direct = {im.cpu().numpy().tobytes(): d
                  for im, d in zip(batches[0], xf.detectAndCompute(
                      batches[0]))}
        for res, im in zip(results, imgs):
            for k in ("keypoints", "scores", "descriptors"):
                np.testing.assert_array_equal(
                    res[k], direct[im.tobytes()][k].cpu().numpy())
        m = mnn.batch_mnn_match_fused.launches
        out = post("/match?mode=mnn", image0=imgs[0], image1=imgs[1])
        assert mnn.batch_mnn_match_fused.launches == m + 1
        ref = xf.match_xfeat(imgs[0], imgs[1])
        np.testing.assert_array_equal(out["mkpts0"], ref[0])
        np.testing.assert_array_equal(out["mkpts1"], ref[1])
    finally:
        httpd.service.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)


def test_stage_ranges_put_nothing_on_the_device_timeline(dev):
    """Under a CUDA profiler the port's `xfeat.*` ranges are host ranges
    only (the profiler projects user annotations onto the device's
    timeline; these are not), every kernel of the three entries is
    launched inside one of them, and the outputs equal an unprofiled
    call's to the bit."""
    from torch.profiler import ProfilerActivity, profile

    from accelerated_features_tpu_torch.ops.extraction import \
        detect_and_compute
    gen = torch.Generator().manual_seed(3)
    params = to_dev(load_params(None), dev)
    imgs = torch.randint(0, 256, (2, 96, 128, 1), dtype=torch.uint8,
                         generator=gen).to(dev)
    lgp = to_dev(lighterglue.init_lighterglue_params(gen), dev)
    size = torch.tensor([[128.0, 96.0]], device=dev)

    def calls():
        f = detect_and_compute(params, imgs, 64, 0.0)
        m = lighterglue.lighterglue_forward(
            lgp, f["keypoints"][:1], f["keypoints"][1:],
            f["descriptors"][:1], f["descriptors"][1:], size, size,
            f["valid"][:1], f["valid"][1:], width_confidence=0.95,
            pruning_min_kpts=0)
        idx, mask = mnn.batch_mnn_match_fused(
            f["descriptors"][:1], f["descriptors"][1:], f["valid"][:1],
            f["valid"][1:])
        return [f[k] for k in sorted(f)] + [m["matches0"], m["mscores0"],
                                            idx, mask]

    plain = calls()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = calls()
        torch.cuda.synchronize()
    for a, b in zip(plain, traced):
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda]
    assert not [e.name() for e in device if e.name().startswith("xfeat.")]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
              if e.device_type() != cuda and e.name().startswith("xfeat.")]
    names = {e.name() for e in events if e.name().startswith("xfeat.")}
    assert {"xfeat.extract.backbone", "xfeat.lighterglue.prune",
            "xfeat.lighterglue.assign", "xfeat.mnn"} <= names
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != cuda
              and e.name().startswith(("cuda", "cu"))}
    kernels = [e for e in device
               if not e.name().lower().startswith(("memcpy", "memset"))]
    assert kernels
    for e in kernels:
        t = launch[e.correlation_id()]
        assert any(a <= t < b for a, b in ranges), e.name()
