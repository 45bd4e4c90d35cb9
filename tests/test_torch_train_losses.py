"""CPU parity of the port's training losses (`train/losses.py`), training
utilities (`train/utils.py`) and kernel D's plain backward
(`ops/cuda/attention.attention_backward_reference`) against the JAX
package: the same numpy-seeded inputs and the same injected random draws
through both, values and input gradients compared.

Tolerances: loss values rtol 1e-5; gradients max |diff| <= 1e-4 x the
largest |gradient| of that input (float32 on both sides, sums in other
orders)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.train import losses as jl
from accelerated_features_tpu.train import utils as ju
from accelerated_features_tpu_torch.ops.cuda import attention
from accelerated_features_tpu_torch.train import losses as tl
from accelerated_features_tpu_torch.train import utils as tu

from torch_support import t

M = 32


def check_value_and_grads(jfn, tfn, *inputs):
    """jfn and tfn take the float inputs and return a scalar; compares the
    value (rtol 1e-5) and every input's gradient (1e-4 x its max)."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    ts = [t(a, grad=True) for a in inputs]
    tv = tfn(*ts)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5,
                               atol=1e-7)
    for g, x in zip(jg, ts):
        g = np.asarray(g)
        got = x.grad.numpy() if x.grad is not None else np.zeros_like(g)
        assert np.abs(got - g).max() <= 1e-4 * max(np.abs(g).max(), 1e-30)


@pytest.fixture
def data():
    rng = np.random.default_rng(3)
    return {
        "m1": rng.normal(size=(M, 64)).astype(np.float32),
        "m2": rng.normal(size=(M, 64)).astype(np.float32),
        "valid": rng.uniform(size=M) > 0.25,
        "logits": rng.normal(size=(M, 64)).astype(np.float32),
        "pts": rng.uniform(2, 6, (M, 2)).astype(np.float32),
        "conf": rng.uniform(size=M).astype(np.float32),
        "h1": rng.uniform(size=M).astype(np.float32),
        "h2": rng.uniform(size=M).astype(np.float32),
    }


def test_dual_softmax_loss(data):
    v = data["valid"]
    check_value_and_grads(
        lambda a, b: jl.dual_softmax_loss(a, b, jnp.asarray(v))[0],
        lambda a, b: tl.dual_softmax_loss(a, b, t(v))[0],
        data["m1"], data["m2"])
    _, jc = jl.dual_softmax_loss(jnp.asarray(data["m1"]),
                                 jnp.asarray(data["m2"]), jnp.asarray(v))
    _, tc = tl.dual_softmax_loss(t(data["m1"]), t(data["m2"]), t(v))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)


def test_coordinate_classification_loss(data):
    v, pts, conf = data["valid"], data["pts"], data["conf"]
    check_value_and_grads(
        lambda c: jl.coordinate_classification_loss(
            c, jnp.asarray(pts), jnp.asarray(conf), jnp.asarray(v))[0],
        lambda c: tl.coordinate_classification_loss(
            c, t(pts), t(conf), t(v))[0], data["logits"])
    ja = jl.coordinate_classification_loss(
        jnp.asarray(data["logits"]), jnp.asarray(pts), jnp.asarray(conf),
        jnp.asarray(v))[1]
    ta = tl.coordinate_classification_loss(
        t(data["logits"]), t(pts), t(conf), t(v))[1]
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)


def test_keypoint_reliability_loss(data):
    v, conf = data["valid"], data["conf"]
    check_value_and_grads(
        lambda a, b: jl.keypoint_reliability_loss(a, b, jnp.asarray(conf),
                                                  jnp.asarray(v)),
        lambda a, b: tl.keypoint_reliability_loss(a, b, t(conf), t(v)),
        data["h1"], data["h2"])


def _teacher_kpts(rng, n=60, hw=(48, 64)):
    kpts = rng.uniform(0, 1, (n, 2)) * np.array([hw[1], hw[0]])
    kpts[5] = kpts[4] + 0.5        # a cell collision: the higher index wins
    return kpts.astype(np.float32), rng.uniform(size=n) > 0.2


def test_distill_labels_and_loss_with_injected_keep_mask():
    rng = np.random.default_rng(5)
    kpts, valid = _teacher_kpts(rng)
    h, w = 6, 8
    jlab = np.asarray(jl.distill_labels_from_kpts(jnp.asarray(kpts),
                                                  jnp.asarray(valid), h, w))
    tlab = tl.distill_labels_from_kpts(t(kpts), t(valid), h, w)
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    assert (jlab < 64).sum() > 10

    # JAX's Bernoulli draw, reproduced from its key and handed to the port
    key = jax.random.key(9)
    pos = jlab.reshape(-1) < 64
    p_neg = float(tl.distill_keep_probability(tlab))
    keep = np.asarray(jax.random.bernoulli(
        key, jnp.clip((pos.sum() / 32.0) / max((~pos).sum(), 1), 0, 1),
        (h * w,)))
    assert p_neg == pytest.approx(float(jnp.clip((pos.sum() / 32.0)
                                                 / max((~pos).sum(), 1),
                                                 0, 1)), rel=1e-6)
    logits = rng.normal(size=(h, w, 65)).astype(np.float32)
    check_value_and_grads(
        lambda x: jl.distill_loss(x, jnp.asarray(jlab), key)[0],
        lambda x: tl.distill_loss(x, tlab, keep_neg=t(keep))[0], logits)
    g = torch.Generator().manual_seed(0)
    loss, acc = tl.distill_loss(t(logits), tlab, g)
    assert torch.isfinite(loss) and 0 <= float(acc) <= 1


def test_hard_triplet_and_smooth_l1(data):
    v = data["valid"]
    check_value_and_grads(
        lambda a, b: jl.hard_triplet_loss(a, b, jnp.asarray(v)),
        lambda a, b: tl.hard_triplet_loss(a, b, t(v)),
        data["m1"] * 0.1, data["m2"] * 0.1)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(M, 3)).astype(np.float32) * 3
    y = rng.normal(size=(M, 3)).astype(np.float32)
    for valid in (None, v):
        for avg in (True, False):
            check_value_and_grads(
                lambda a: jl.smooth_l1_loss(
                    a, jnp.asarray(y), valid=None if valid is None
                    else jnp.asarray(valid), size_average=avg),
                lambda a: tl.smooth_l1_loss(
                    a, t(y), valid=None if valid is None else t(valid),
                    size_average=avg), x)


def test_keypoint_position_loss():
    """Correspondences from a known shift, so view-1 argmax cells hit the
    hashmap; a duplicate source pixel resolves to the higher index."""
    rng = np.random.default_rng(11)
    h, w = 6, 8
    logits1 = rng.normal(size=(h, w, 65)).astype(np.float32)
    logits2 = rng.normal(size=(h, w, 65)).astype(np.float32)
    ys, xs = np.mgrid[0:h * 8, 0:w * 8]
    p1 = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32) + 0.25
    p2 = p1 + np.array([3.0, 2.0], np.float32)
    keep = rng.uniform(size=len(p1)) > 0.1
    p1[1] = p1[0] + 0.5  # row 0's source pixel after the int cast
    valid = keep & (p2[:, 0] < w * 8) & (p2[:, 1] < h * 8)
    check_value_and_grads(
        lambda a, b: jl.keypoint_position_loss(
            a, b, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))[0],
        lambda a, b: tl.keypoint_position_loss(
            a, b, t(p1), t(p2), t(valid))[0], logits1, logits2)
    ja = jl.keypoint_position_loss(
        jnp.asarray(logits1), jnp.asarray(logits2), jnp.asarray(p1),
        jnp.asarray(p2), jnp.asarray(valid))
    ta = tl.keypoint_position_loss(t(logits1), t(logits2), t(p1), t(p2),
                                   t(valid))
    assert float(ja[0]) > 0
    assert float(ta[1]) == pytest.approx(float(ja[1]), rel=1e-6)


def test_fine_loss_with_injected_offsets():
    rng = np.random.default_rng(4)
    f1 = rng.normal(size=(20, 24, 8)).astype(np.float32)
    f2 = rng.normal(size=(20, 24, 8)).astype(np.float32)
    p1 = rng.uniform(0, 20, (10, 2)).astype(np.float32)
    p2 = rng.uniform(0, 20, (10, 2)).astype(np.float32)
    offs = rng.uniform(-3, 3, (10, 2)).astype(np.float32)
    valid = rng.uniform(size=10) > 0.3
    check_value_and_grads(
        lambda a, b: jl.fine_loss(a, b, jnp.asarray(p1), jnp.asarray(p2),
                                  lambda x, y: (x * 2, y), None,
                                  jnp.asarray(valid),
                                  offsets=jnp.asarray(offs)),
        lambda a, b: tl.fine_loss(a, b, t(p1), t(p2),
                                  lambda x, y: (x * 2, y), None, t(valid),
                                  offsets=t(offs)), f1, f2)


def test_check_accuracy_and_crop_patches(data):
    v = data["valid"]
    m2 = data["m1"] + 0.3 * data["m2"]
    for valid in (None, v):
        ja = ju.check_accuracy(jnp.asarray(data["m1"]), jnp.asarray(m2),
                               None if valid is None else jnp.asarray(valid))
        ta = tu.check_accuracy(t(data["m1"]), t(m2),
                               None if valid is None else t(valid))
        assert float(ta) == pytest.approx(float(ja), rel=1e-6)
    rng = np.random.default_rng(2)
    maps = rng.normal(size=(10, 12, 5)).astype(np.float32)
    coords = rng.integers(-2, 14, (9, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        tu.crop_patches(t(maps), t(coords)).numpy(),
        np.asarray(ju.crop_patches(jnp.asarray(maps), jnp.asarray(coords))))


def test_teacher_labels(tmp_path):
    rng = np.random.default_rng(6)
    kpts, _ = _teacher_kpts(rng, 40, (32, 48))
    images = rng.uniform(size=(2, 32, 48, 1)).astype(np.float32)

    def teacher(img):
        return kpts[: 20 + int(img.mean() > 0.5)]
    jlab = np.asarray(ju.teacher_labels_for_batch(jnp.asarray(images),
                                                  teacher, max_kpts=30))
    tlab = tu.teacher_labels_for_batch(t(images), teacher, max_kpts=30)
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    path = str(tmp_path / "teacher.npz")
    tu.save_teacher_keypoints(path, {"a": kpts})
    np.testing.assert_array_equal(
        tu.PrecomputedTeacher(path).labels("a", (4, 6)).numpy(),
        np.asarray(ju.PrecomputedTeacher(path).labels("a", (4, 6))))


@pytest.mark.parametrize("heads,masked", [(1, "ragged"), (3, "ragged"),
                                          (1, "item empty"), (3, None)])
def test_attention_backward_reference_matches_jax_grad(heads, masked):
    """The plain backward of kernel D (its formulas, from the saved
    log-sum-exp) against `jax.grad` of the JAX package's dense attention:
    heads 1 and 3 (folded into the batch as the port folds them), ragged
    key masks, and an item whose keys are all masked."""
    rng = np.random.default_rng(heads + (masked is None))
    b, m, n, d = 2, 40, 56, 96
    q, k, v = (rng.normal(size=(b, x, d)).astype(np.float32)
               for x in (m, n, n))
    dout = rng.normal(size=(b, m, d)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, n)) > 0.3
        mask[0, 40:] = False
        if masked == "item empty":
            mask[1] = False
    jm = None if mask is None else jnp.asarray(mask)
    jg = jax.grad(lambda a, c, e: jnp.sum(
        jlg._attention(a, c, e, jm, heads) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    hd = d // heads

    def split(x):
        return t(x).reshape(b, -1, heads, hd).transpose(1, 2).reshape(
            b * heads, -1, hd)

    def merge(x):
        return x.reshape(b, heads, -1, hd).transpose(1, 2).reshape(b, -1, d)
    mh = None if mask is None else t(mask).repeat_interleave(heads, 0)
    scale = 1.0 / math.sqrt(hd)
    qh, kh, vh = split(q), split(k), split(v)
    o, lse = attention.attention_reference_lse(qh, kh, vh, mh, scale)
    got = attention.attention_backward_reference(qh, kh, vh, mh, o, lse,
                                                 split(dout), scale)
    for g, x in zip(jg, got):
        g = np.asarray(g)
        assert np.abs(merge(x).numpy() - g).max() <= 1e-4 * np.abs(g).max()
    if masked == "item empty":
        np.testing.assert_allclose(merge(got[2])[1].numpy(),
                                   np.broadcast_to(dout[1].sum(0) / n,
                                                   (n, d)),
                                   rtol=1e-5, atol=1e-6)
        assert not merge(got[0])[1].any()


def test_flash_attention_autograd_on_the_cpu_uses_the_plain_backward():
    """On CPU tensors that require grad, `flash_attention` records the
    same function: its gradients equal autograd through
    `attention_reference`, and nothing is launched."""
    rng = np.random.default_rng(0)
    q, k, v = (t(rng.normal(size=(2, x, 32)).astype(np.float32), True)
               for x in (30, 45, 45))
    mask = t(rng.uniform(size=(2, 45)) > 0.4)
    g = t(rng.normal(size=(2, 30, 32)).astype(np.float32))
    before = (attention.flash_attention.launches,
              attention.attention_backward.launches)
    attention.flash_attention(q, k, v, mask).backward(g)
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    attention.attention_reference(q, k, v, mask).backward(g)
    for a, x in zip(got, (q, k, v)):
        torch.testing.assert_close(a, x.grad, atol=1e-5, rtol=1e-5)
    assert (attention.flash_attention.launches,
            attention.attention_backward.launches) == before
