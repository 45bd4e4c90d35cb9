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
from accelerated_features_tpu_torch.ops.cuda import (attention, bicubic,
                                                     detect_fused, mnn)
from accelerated_features_tpu_torch.ops.detect import heatmap_decode
from accelerated_features_tpu_torch.ops.matching import batch_mnn_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,w,thr", [(1, 5, 9, 0.012), (3, 8, 16, 0.012),
                                       (2, 4, 4, 0.0)])
def test_detect_kernel_matches_plain(dev, b, h, w, thr):
    rng = np.random.default_rng(h * w)
    logits = torch.tensor(rng.normal(size=(b, h, w, 65)) * 3,
                          dtype=torch.float32)
    kheat = heatmap_decode(logits)
    if thr == 0.0:  # flat regions: every tied pixel is a local max
        kheat = torch.round(kheat * 64) / 64
    rel = torch.tensor(rng.uniform(0.1, 1, (b, h, w)), dtype=torch.float32)
    best_p, sub_p = detect_fused.plain_candidates(kheat.to(dev), rel.to(dev),
                                                  thr)
    n = detect_fused.detect_candidates.launches
    best_k, sub_k = detect_fused.detect_candidates(kheat.to(dev), rel.to(dev),
                                                   thr)
    assert detect_fused.detect_candidates.launches == n + 1
    assert torch.equal(best_k, best_p) and torch.equal(sub_k, sub_p)


@pytest.mark.parametrize("b,h,w,k", [(1, 10, 13, 70), (2, 76, 100, 33)])
def test_bicubic_kernel_matches_plain(dev, b, h, w, k):
    rng = np.random.default_rng(k)
    H, W = h * 8, w * 8
    maps = torch.tensor(rng.normal(size=(b, h, w, 64)), dtype=torch.float32)
    pos = torch.tensor(np.stack([rng.uniform(-9, W + 9, (b, k)),
                                 rng.uniform(-9, H + 9, (b, k))], -1),
                       dtype=torch.float32)
    pos[:, 0] = torch.tensor([W - 1, H - 1], dtype=torch.float32)
    ref = bicubic.plain_descriptors(maps.to(dev), pos.to(dev), (H, W))
    got = bicubic.sample_descriptors(maps.to(dev), pos.to(dev), (H, W))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("k1,k2,gate", [(100, 37, -1.0), (129, 300, 0.2),
                                        (64, 64, 0.82)])
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


def test_lighterglue_attention_routes_to_the_kernel(dev):
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(1, 50, 96)),
                            dtype=torch.float32, device=dev) for _ in range(3))
    n = attention.flash_attention.launches
    got = lighterglue._attention(q, k, v, None, heads=1)
    assert attention.flash_attention.launches == n + 1
    torch.testing.assert_close(got, attention.attention_reference(q, k, v),
                               **ATTN_TOL)
    with pytest.raises(NotImplementedError):
        lighterglue._attention(q, k, v, None, heads=2)


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
        detect_fused.detect_candidates(torch.zeros(1, 7, 8, device=dev),
                                       torch.zeros(1, 1, 1, device=dev))
    with pytest.raises(ValueError):
        bicubic.sample_descriptors(torch.zeros(1, 2, 2, 32, device=dev),
                                   torch.zeros(1, 3, 2, device=dev), (16, 16))
    with pytest.raises(ValueError):
        d2 = torch.zeros(1, 64, 4, device=dev).transpose(1, 2)  # strided
        mnn.batch_mnn_match_fused(torch.zeros(1, 4, 64, device=dev), d2)
