"""CPU parity of the port's LighterGlue trainer against the JAX package:
the assignment NLL, the gradient of `lighterglue_loss` with respect to
every matcher parameter (a 2-layer, 32-wide, one-head matcher; the
attention's backward on the CPU is kernel D's plain backward), the batch
`build_lg_batch` derives from the analytic warp, and
`lighterglue_run.main` for two steps on a PNG folder, resumed, and loaded
into `XFeat.set_lighterglue`.

Tolerances: losses rtol 1e-5; gradients max |diff| <= 1e-4 x the leaf's
max |g|; keypoints and descriptors of the frozen extractor as the
pipeline parity tests hold them (equal keypoints, descriptors atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import load_params as jax_load_params
from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.train import augmentation as ja
from accelerated_features_tpu.train import lighterglue_loss as jll
from accelerated_features_tpu.train import lighterglue_run as jrun
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.models.params import (
    load_lighterglue_params, load_params, params_to_jax)
from accelerated_features_tpu_torch.ops.cuda import attention
from accelerated_features_tpu_torch.train import augmentation as ta
from accelerated_features_tpu_torch.train import lighterglue_loss as tll
from accelerated_features_tpu_torch.train import lighterglue_run as trun

from torch_support import CKPT, leaves, t

SMALL = {**jlg.DEFAULT_CONF, "descriptor_dim": 32, "n_layers": 2}


def _lg_batch(rng, b=2, m=24, s=10):
    mask0 = np.arange(m)[None] < np.array([[m], [m - 7]])[:b]
    mask1 = np.arange(m)[None] < np.array([[m - 3], [m]])[:b]
    idx0 = np.stack([rng.permutation(m - 7)[:s] for _ in range(b)])
    idx1 = np.stack([rng.permutation(m - 3)[:s] for _ in range(b)])
    return {
        "kpts0": rng.uniform(0, 128, (b, m, 2)).astype(np.float32),
        "kpts1": rng.uniform(0, 128, (b, m, 2)).astype(np.float32),
        "descs0": rng.normal(size=(b, m, 64)).astype(np.float32),
        "descs1": rng.normal(size=(b, m, 64)).astype(np.float32),
        "size0": np.full((b, 2), 128.0, np.float32),
        "size1": np.full((b, 2), 128.0, np.float32),
        "mask0": mask0, "mask1": mask1,
        "gt_idx0": idx0.astype(np.int32), "gt_idx1": idx1.astype(np.int32),
        "gt_valid": rng.uniform(size=(b, s)) > 0.2,
        "unmatched0": mask0 & (rng.uniform(size=(b, m)) > 0.7),
        "unmatched1": mask1 & (rng.uniform(size=(b, m)) > 0.7),
    }


def test_assignment_nll():
    rng = np.random.default_rng(0)
    b = _lg_batch(rng)
    la = rng.normal(size=(2, 25, 25)).astype(np.float32)
    args = ("gt_idx0", "gt_idx1", "gt_valid", "unmatched0", "unmatched1")

    def jf(x):
        return jll.assignment_nll(x, *[jnp.asarray(b[k]) for k in args])[0]
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(la))
    x = t(la).requires_grad_()
    tv, tm = tll.assignment_nll(x, *[t(b[k]) for k in args])
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7)
    jm = jll.assignment_nll(jnp.asarray(la), *[jnp.asarray(b[k])
                                               for k in args])[1]
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


def test_lighterglue_loss_gradients():
    jparams = jax.tree.map(np.asarray,
                           jlg.init_lighterglue_params(jax.random.key(3),
                                                       SMALL))
    batch = _lg_batch(np.random.default_rng(1))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jll.lighterglue_loss(p, jbatch), has_aux=True))(jparams)
    before = attention.attention_backward.launches
    tloss, _, tg = trun.loss_and_grads(load_lighterglue_params(jparams),
                                       {k: t(v) for k, v in batch.items()})
    assert attention.attention_backward.launches == before  # plain on CPU
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    jgl, tgl = leaves(jg), leaves(params_to_jax(tg))
    assert jgl.keys() == tgl.keys()
    for k, g in jgl.items():
        assert np.abs(tgl[k] - g).max() <= 1e-4 * np.abs(g).max() + 1e-30, k
    assert not np.abs(jgl["token_confidence/0/w"]).any()


def test_build_lg_batch():
    """The frozen trained extractor on both views of one warped pair (the
    JAX package's transforms), and the ground truth from the analytic
    warp."""
    rng = np.random.default_rng(5)
    g = rng.uniform(size=(2, 24, 32, 3)).astype(np.float32)
    imgs = np.asarray(jax.image.resize(g, (2, 192, 256, 3), "bicubic"))
    cfg_j = ja.AugConfig(warp_resolution=(256, 192),
                         out_resolution=(256, 192), photometric=False)
    cfg_t = ta.AugConfig(warp_resolution=(256, 192),
                         out_resolution=(256, 192), photometric=False)
    pair_j = ja.make_pair(jax.random.key(1), jnp.asarray(imgs), cfg_j)
    pair_t = {k: (tuple(t(x) for x in v) if k == "tps2" else t(v))
              for k, v in pair_j.items()}
    jb = jrun.build_lg_batch(jax_load_params(CKPT), pair_j, cfg_j,
                             top_k=128)
    tb = trun.build_lg_batch(load_params(CKPT), pair_t, cfg_t, top_k=128)
    for k in ("kpts0", "kpts1", "mask0", "mask1", "size0"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)
    for k in ("descs0", "descs1"):
        np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                   atol=1e-5)
    for k in ("gt_valid", "unmatched0", "unmatched1"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)
    v = np.asarray(jb["gt_valid"])
    assert v.sum() > 5
    for k in ("gt_idx0", "gt_idx1"):
        np.testing.assert_array_equal(tb[k].numpy()[v], np.asarray(jb[k])[v])


def test_lighterglue_run_two_steps_on_the_cpu(tmp_path):
    import cv2
    rng = np.random.default_rng(0)
    folder = tmp_path / "pngs"
    folder.mkdir()
    for i in range(10):
        g = rng.uniform(0, 255, (12, 16, 3)).astype(np.uint8)
        cv2.imwrite(str(folder / f"im{i}.png"),
                    cv2.resize(g, (160, 120), interpolation=cv2.INTER_CUBIC))
    args = ["--synthetic_root_path", str(folder), "--ckpt_save_path",
            str(tmp_path / "lg"), "--xfeat_weights", CKPT, "--device",
            "cpu", "--training_res", "128,96", "--batch_size", "2",
            "--top_k", "64"]
    history = trun.main(args + ["--n_steps", "2"])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (tmp_path / "lg" / "ckpt_00000002.npz").exists()
    again = trun.main(args + ["--n_steps", "3"])  # resumes at step 2
    assert [h["step"] for h in again] == [3]
    xf = XFeat(weights=None, device="cpu")
    xf.set_lighterglue(str(tmp_path / "lg"))
    got = xf._lighterglue.params["input_proj"]["w"]
    ref = load_lighterglue_params(str(tmp_path / "lg" / "ckpt_00000003.npz"))
    assert torch.equal(got, ref["input_proj"]["w"])
