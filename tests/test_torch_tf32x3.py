"""The 3xTF32 arithmetic of kernels C (`csrc/mnn.cu`) and D
(`csrc/attention.cu`, and its backward `csrc/attention_bwd.cu`), emulated
on the CPU by `ops.precision`: does a product summed from three TF32
tensor-core products keep the float32 gates of the kernels? A single TF32
pass must fail the same checks, so the tests can tell the two apart."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.ops.pallas.attention import \
    attention_reference as jax_attention_reference
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.ops.cuda.attention import (
    NEG as ATTN_NEG, attention_reference)
from accelerated_features_tpu_torch.ops.cuda.mnn import near_ties
from accelerated_features_tpu_torch.ops.matching import NEG, batch_mnn_match
from accelerated_features_tpu_torch.ops.precision import (full_fp32_convs,
                                                          full_fp32_matmuls,
                                                          tf32_cut,
                                                          tf32_matmul,
                                                          tf32_round,
                                                          tf32_split,
                                                          tf32x3_matmul)

from torch_support import CKPT, HOLDOUT_SCENES

SOURCES = ("holdout", "seeded")


def _holdout_descriptors():
    """Descriptors of one pair of the committed rendered holdout, extracted
    by the port on the CPU: (1,K,64) each, K = 2048 (the eval's top_k)."""
    cv2 = pytest.importorskip("cv2")
    scene = HOLDOUT_SCENES / "rendered" / "holdout_0012" / "imgs"
    xf = XFeat(weights=CKPT, top_k=2048, device="cpu")
    descs = []
    for name in ("view_0.png", "view_1.png"):
        im = cv2.imread(str(scene / name))
        assert im is not None
        descs.append(xf.detectAndCompute(im)[0]["descriptors"][None])
    return descs


def _seeded_descriptors():
    """Unit vectors, d2 a noisy permutation of d1: (2,1500,64), (2,1300,64)."""
    rng = np.random.default_rng(5)
    b, k1, k2 = 2, 1500, 1300
    d1 = rng.normal(size=(b, k1, 64))
    d2 = d1[:, rng.integers(0, k1, k2)] + rng.normal(size=(b, k2, 64)) * 0.5
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return [torch.tensor(d, dtype=torch.float32) for d in (d1, d2)]


@pytest.fixture(scope="module")
def descriptors():
    made = {}

    def get(source):
        if source not in made:
            made[source] = (_holdout_descriptors() if source == "holdout"
                            else _seeded_descriptors())
        return made[source]
    return get


def _masks(d1, d2, masked):
    if not masked:
        return None, None
    g = torch.Generator().manual_seed(3)
    return (torch.rand(d1.shape[:2], generator=g) > 0.2,
            torch.rand(d2.shape[:2], generator=g) > 0.2)


def mnn_from_similarity(sim, valid1, valid2, min_cossim):
    """`batch_mnn_match` on a given (B,K1,K2) similarity."""
    if valid2 is not None:
        sim = torch.where(valid2[:, None, :], sim, NEG)
    simT = sim.transpose(1, 2)
    if valid1 is not None:
        simT = torch.where(valid1[:, None, :], simT, NEG)
    match12, match21 = sim.argmax(dim=2), simT.argmax(dim=2)
    mask = torch.gather(match21, 1, match12) == torch.arange(sim.shape[1])
    if valid1 is not None:
        mask = mask & valid1
    if min_cossim > 0:
        mask = mask & (sim.max(dim=2).values > min_cossim)
    return match12, mask


def _off_tie_rows(matmul, d1, d2, v1, v2, gate):
    """(rows that differ from the plain version off the 1e-6 near-ties,
    largest float64 shortfall of the picked column below the row's best)."""
    sim = matmul(d1, d2.transpose(1, 2))
    i_e, m_e = mnn_from_similarity(sim, v1, v2, gate)
    i_p, m_p = batch_mnn_match(d1, d2, v1, v2, gate)
    tie, smax = near_ties(d1, d2, v1, v2, gate, eps=1e-6)
    assert int(tie.sum()) <= tie.numel() // 100
    diff = (i_e != i_p) | (m_e != m_p)
    picked = (d1.double() * torch.gather(
        d2.double(), 1, i_e[..., None].expand(-1, -1, 64))).sum(-1)
    has = smax > -1e8
    return int((diff & ~tie).sum()), float((smax - picked)[has].max())


@pytest.mark.parametrize("x", [1.0, -1.0, 1.00048828125, -1.00048828125,
                               1.000732421875, 0.1, -3.14159274, 1e-20, 0.0])
def test_tf32_round_is_nearest_ties_away(x):
    """Against the definition: scale to the TF32 step of x's binade, round
    half away from zero in float64."""
    got = float(tf32_round(torch.tensor([x], dtype=torch.float32))[0])
    xf = float(np.float32(x))
    if xf == 0.0:
        assert got == 0.0
        return
    step = 2.0 ** (math.floor(math.log2(abs(xf))) - 10)
    want = math.copysign(math.floor(abs(xf) / step + 0.5) * step, xf)
    assert got == want
    assert abs(float(tf32_cut(torch.tensor([x], dtype=torch.float32))[0])) \
        == math.floor(abs(xf) / step) * step


@pytest.mark.parametrize("cut", [False, True])
def test_split_keeps_the_value(cut):
    """hi and lo are TF32 values and hi + lo is x to 2^-22 (2^-20 cut)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=4096) * 10.0 ** rng.integers(-3, 4, 4096),
                     dtype=torch.float32)
    hi, lo = tf32_split(x, cut)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert float(rel.max()) <= 2.0 ** (-20 if cut else -22)
    assert float((lo.abs() / x.abs()).max()) <= 2.0 ** (-10 if cut else -11)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("gate", [0.82, -1.0])
def test_mnn_on_tf32x3_similarities_differs_only_at_near_ties(
        descriptors, source, masked, gate):
    """Kernel C's gate on the card, here on emulated products: rows may
    differ from `batch_mnn_match` only where `near_ties(eps=1e-6)` marks
    them, and the picked column is within 1e-6 of the row's best."""
    d1, d2 = descriptors(source)
    v1, v2 = _masks(d1, d2, masked)
    off_tie, short = _off_tie_rows(tf32x3_matmul, d1, d2, v1, v2, gate)
    assert off_tie == 0
    assert short <= 1e-6


@pytest.mark.parametrize("source", SOURCES)
def test_mnn_on_single_tf32_similarities_fails_the_same_gate(descriptors,
                                                             source):
    """One TF32 pass (~1e-3 relative) picks other columns off the near-ties
    and falls short of the row's best by more than the gate's 1e-6."""
    d1, d2 = descriptors(source)
    off_tie, short = _off_tie_rows(tf32_matmul, d1, d2, None, None, -1.0)
    assert off_tie > 0
    assert short > 1e-6


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("masked", [False, True])
def test_mnn_on_tf32x3_is_bit_equal_on_rounded_descriptors(descriptors,
                                                           source, masked):
    """Descriptors rounded to 1/128 are TF32 values (lo = 0) and every
    partial sum is exact, so the emulated similarities equal the float32
    ones to the bit, ties included."""
    d1, d2 = (torch.round(d * 128) / 128 for d in descriptors(source))
    v1, v2 = _masks(d1, d2, masked)
    sim = tf32x3_matmul(d1, d2.transpose(1, 2))
    assert torch.equal(sim, torch.matmul(d1, d2.transpose(1, 2)))
    i_e, m_e = mnn_from_similarity(sim, v1, v2, 0.82)
    i_p, m_p = batch_mnn_match(d1, d2, v1, v2, 0.82)
    assert torch.equal(i_e, i_p) and torch.equal(m_e, m_p)


def attention_emulated(q, k, v, mask_k, matmul):
    """`attention_reference` with both products through `matmul`."""
    s = matmul(q, k.transpose(1, 2)) * (1.0 / math.sqrt(q.shape[-1]))
    if mask_k is not None:
        s = torch.where(mask_k[:, None, :], s, -1e9)
    return matmul(torch.softmax(s, dim=-1), v)


def _attention_inputs(d, masked):
    rng = np.random.default_rng(d)
    b, nq, nk = 2, 300, 421
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32)
               for n in (nq, nk, nk))
    mask = rng.uniform(size=(b, nk)) > 0.3 if masked else None
    if masked:
        mask[1] = False  # an item with no unmasked key: the mean of V
    return q, k, v, mask


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cut", [False, True])
def test_attention_on_tf32x3_products_keeps_the_gate(d, masked, cut):
    """Kernel D's gate, 2e-5 + 1e-4 |ref|, on emulated products with the
    exact split and with the cut split the kernel uses: against the port's
    plain version and against the JAX package's, on the same numpy inputs."""
    q, k, v, mask = _attention_inputs(d, masked)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    got = attention_emulated(tq, tk, tv, tm,
                             lambda a, b: tf32x3_matmul(a, b, cut))
    ref = attention_reference(tq, tk, tv, tm)
    ref_jax = np.array(jax_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask)))
    assert bool(torch.isfinite(got).all())
    for want in (ref, torch.from_numpy(ref_jax)):
        assert bool(((got - want).abs() <= 2e-5 + 1e-4 * want.abs()).all())
    if masked:
        assert float((got[1] - tv[1].mean(0)).abs().max()) <= 1e-5


@pytest.mark.parametrize("d", [32, 96])
def test_attention_on_single_tf32_products_fails_the_gate(d):
    q, k, v, _ = _attention_inputs(d, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention_emulated(tq, tk, tv, None, tf32_matmul)
    ref = attention_reference(tq, tk, tv, None)
    assert bool(((got - ref).abs() > 2e-5 + 1e-4 * ref.abs()).any())


def attention_backward_emulated(q, k, v, mask_k, dout, matmul):
    """Kernel D's forward and backward with every product through `matmul`:
    o and the row log-sum-exp as the forward kernel gives them, then the
    formulas of `attention_backward_reference` (P from the log-sum-exp,
    dV = P^T dO, dP = dO V^T, dS = P (dP - Delta) cut at masked keys,
    dQ = scale dS K, dK = scale dS^T Q; an item whose keys are all masked
    has P = 1/Nk). Returns (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = matmul(q, k.transpose(1, 2)) * scale
    if mask_k is not None:
        s = torch.where(mask_k[:, None, :], s, ATTN_NEG)
    lse = torch.logsumexp(s, dim=-1)
    o = matmul(torch.softmax(s, dim=-1), v)
    p = torch.exp(s - lse[..., None])
    if mask_k is not None:
        p = torch.where(mask_k[:, None, :], p, 0.0)
        empty = ~mask_k.any(dim=-1)
        p = torch.where(empty[:, None, None], 1.0 / k.shape[1], p)
    dv = matmul(p.transpose(1, 2), dout)
    delta = (dout * o).sum(dim=-1, keepdim=True)
    ds = p * (matmul(dout, v.transpose(1, 2)) - delta)
    if mask_k is not None:
        ds = torch.where(mask_k[:, None, :], ds, 0.0)
    return (matmul(ds, k) * scale, matmul(ds.transpose(1, 2), q) * scale,
            dv)


def _backward_references(q, k, v, mask, dout):
    """(float64 autograd of `attention_reference`, `jax.grad` of the JAX
    package's LighterGlue attention), each (dq, dk, dv) as float64."""
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    ref = torch.autograd.grad(attention_reference(*x64, tm),
                              x64, torch.from_numpy(dout).double())
    jm = None if mask is None else jnp.asarray(mask)
    jg = jax.grad(lambda a, c, e: jnp.sum(
        jlg._attention(a, c, e, jm, 1) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return ref, tuple(torch.from_numpy(np.array(x)).double() for x in jg)


def _emulated_backward(d, masked, matmul):
    q, k, v, mask = _attention_inputs(d, masked)
    dout = np.random.default_rng(d + 1).normal(
        size=q.shape).astype(np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tm = None if mask is None else torch.from_numpy(mask)
    got = attention_backward_emulated(tq, tk, tv, tm, tdo, matmul)
    return got, _backward_references(q, k, v, mask, dout), dout


@pytest.mark.parametrize("d", [32, 64, 96])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cut", [False, True])
def test_attention_backward_on_tf32x3_products_keeps_the_gate(d, masked,
                                                               cut):
    """The backward kernel's card gate, atol 1e-4 + rtol 1e-3, on emulated
    3xTF32 products (all seven of the forward and the backward) with the
    exact split and with the cut split the kernel uses: dq, dk and dv
    against float64 autograd of `attention_reference` and against
    `jax.grad` of the JAX package's attention, on the same numpy inputs
    (ragged masks and an item whose keys are all masked, or no mask)."""
    got, (ref, ref_jax), dout = _emulated_backward(
        d, masked, lambda a, b: tf32x3_matmul(a, b, cut))
    for x, r, rj in zip(got, ref, ref_jax):
        assert bool(torch.isfinite(x).all())
        for want in (r, rj):
            assert bool(((x.double() - want).abs()
                         <= 1e-4 + 1e-3 * want.abs()).all())
    if masked:  # the empty item: dv = colsum(dO)/Nk, dq = dk = 0
        nk = got[2].shape[1]
        want = torch.from_numpy(dout[1].sum(0) / nk).expand(nk, -1)
        assert float((got[2][1] - want).abs().max()) <= 1e-5
        assert not got[0][1].any() and not got[1][1].any()


@pytest.mark.parametrize("d", [32, 96])
def test_attention_backward_on_single_tf32_products_fails_the_gate(d):
    got, (ref, _), _ = _emulated_backward(d, True, tf32_matmul)
    assert any(bool(((x.double() - r).abs() > 1e-4 + 1e-3 * r.abs()).any())
               for x, r in zip(got, ref))


@pytest.mark.parametrize("switch,backend", [
    (full_fp32_convs, torch.backends.cudnn),
    (full_fp32_matmuls, torch.backends.cuda.matmul)])
@pytest.mark.parametrize("caller", [True, False])
def test_full_fp32_switches_restore_the_callers_flag(switch, backend,
                                                     caller):
    """Each switch clears its TF32 flag inside the call, as a `with` block
    and as a decorator, and leaves the caller's value after it, also when
    the call raises."""
    prev = backend.allow_tf32
    try:
        backend.allow_tf32 = caller
        with switch():
            assert backend.allow_tf32 is False
        assert backend.allow_tf32 is caller

        @switch()
        def inside():
            return backend.allow_tf32

        assert inside() is False and inside() is False
        assert backend.allow_tf32 is caller
        with pytest.raises(ZeroDivisionError), switch():
            1 / 0
        assert backend.allow_tf32 is caller
    finally:
        backend.allow_tf32 = prev
