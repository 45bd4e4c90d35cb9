"""CPU parity of the port's XFeat trainer against the JAX package: the
backbone and fine matcher in train mode, the learning-rate schedule, and
two consecutive `train_step`s from the same parameters and batch (B=2,
64x64, M=32), with JAX's random draws (the distillation keep-masks)
handed to the port. Then `train/run.py` end to end on the CPU.

Tolerances:
- losses and metrics: rtol 1e-5;
- gradients: max |diff| <= 1e-4 x the leaf's max |g|; a bias right before
  a BatchNorm has a zero gradient in exact arithmetic, so there both
  packages' |g| stay under 1e-6 x the largest gradient;
- parameters after each step: 1e-6 where |g| > 1e-3 x the leaf's max |g|,
  and 2 x lr more for each step where it was not: Adam's first steps move
  an element by ~lr whatever its gradient's size, so a gradient near zero
  may flip its sign between two correct float32 runs;
- BatchNorm running statistics: atol 1e-5 + rtol 1e-4;
- Adam moments: mu as the gradients, nu 2e-4 x the leaf's max.

Correspondences fall on distinct /8 cells, as the trainer's ground truth
does: rows that repeat a cell make the fine matcher's masked BatchNorm
ill-conditioned, and float32 rounding then moves its gradients by ~1%.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.models import backbone as jb
from accelerated_features_tpu.models.params import init_xfeat_params
from accelerated_features_tpu.train import losses as jl
from accelerated_features_tpu.train import trainer as jt
from accelerated_features_tpu.utils import checkpoint as jax_ckpt
from accelerated_features_tpu_torch.models import backbone as tb
from accelerated_features_tpu_torch.models.params import (params_from_jax,
                                                          params_to_jax)
from accelerated_features_tpu_torch.train import run as trun
from accelerated_features_tpu_torch.train import trainer as tt
from accelerated_features_tpu_torch.utils.checkpoint import \
    restore_checkpoint

from torch_support import leaves, t

B, H, W, M = 2, 64, 64, 32
# biases right before a BatchNorm: the batch mean removes them, so their
# gradient is zero in exact arithmetic and rounding noise in float
ZERO_GRAD = {f"fine_matcher/{i}/b" for i in range(4)}


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, init_xfeat_params(jax.random.key(0)))


def test_xfeat_forward_train_mode(params):
    x = np.random.default_rng(0).uniform(size=(B, H, W, 1)) \
        .astype(np.float32)
    jf = jb.xfeat_forward(params, jnp.asarray(x), train=True)
    tf = tb.xfeat_forward(params_from_jax(params), t(x), train=True)
    for a, b in zip(jf[:3], tf[:3]):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=5e-5, rtol=1e-4)
    js, ts = leaves(jf[3]), leaves(params_to_jax(tf[3]))
    assert js.keys() == ts.keys() and len(js) == 2 * 23
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="fused_stem"):
        tb.xfeat_forward(params_from_jax(params), t(x), train=True,
                         fused_stem=True)


def test_fine_matcher_train_mode_with_valid_rows(params):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(M, 128)).astype(np.float32)
    valid = rng.uniform(size=M) > 0.3
    for v in (valid, None):
        jo, js = jb.fine_matcher_forward(
            params, jnp.asarray(x), train=True,
            valid=None if v is None else jnp.asarray(v))
        to, ts = tb.fine_matcher_forward(
            params_from_jax(params), t(x), train=True,
            valid=None if v is None else t(v))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   atol=1e-5, rtol=1e-4)
        for a, b in zip(js, ts):
            for k in ("mean", "var"):
                np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                           atol=1e-5, rtol=1e-4)


def test_learning_rate_schedule():
    """The step's learning rate at optimizer counts 0, lr_step - 1,
    lr_step and past a third halving, against optax's schedule."""
    import optax
    cfg = jt.TrainConfig()
    ref = optax.exponential_decay(cfg.lr, cfg.lr_step, cfg.lr_gamma,
                                  staircase=True)
    sched = tt.lr_schedule(tt.TrainConfig())
    for count in (0, cfg.lr_step - 1, cfg.lr_step, 3 * cfg.lr_step + 5):
        got = sched(torch.tensor(count, dtype=torch.int32))
        assert float(got) == float(ref(jnp.int32(count)))


def _batch(rng, mode):
    def cells():
        c = rng.permutation((H // 8) * (W // 8))[:M]
        return np.stack([c % (W // 8), c // (W // 8)], -1)
    corrs = np.stack([np.concatenate([cells(), cells()], -1)
                      for _ in range(B)]).astype(np.float32) \
        + rng.uniform(0, 1, (B, M, 4)).astype(np.float32)
    b = {"image0": rng.uniform(size=(B, H, W, 1)).astype(np.float32),
         "image1": rng.uniform(size=(B, H, W, 1)).astype(np.float32),
         "corrs": corrs, "corr_valid": rng.uniform(size=(B, M)) > 0.15}
    if mode == "kp_position":
        b["corrs_full"] = rng.uniform(4, 60, (B, M, 4)).astype(np.float32)
        b["corrs_full"][..., 2:] = b["corrs_full"][..., :2] + 1.5
        b["corr_full_valid"] = np.ones((B, M), bool)
    if mode == "distill":
        for i in (0, 1):
            kp = rng.uniform(0, 64, (B, 40, 2)).astype(np.float32)
            b[f"distill_labels{i}"] = np.stack([np.asarray(
                jl.distill_labels_from_kpts(jnp.asarray(k), jnp.ones(40, bool),
                                            H // 8, W // 8)) for k in kp])
    return b


def _jax_keep_masks(batch, key):
    """The keep-masks JAX's loss_fn draws from `key`, (B, 2, h*w)."""
    rngs = jax.random.split(key, (B, 2))
    out = np.zeros((B, 2, (H // 8) * (W // 8)), bool)
    for i in range(B):
        for j in range(2):
            lbl = jnp.asarray(batch[f"distill_labels{j}"][i]).reshape(-1)
            pos = lbl < 64
            p = jnp.clip((jnp.sum(pos).astype(jnp.float32) / 32)
                         / jnp.maximum(jnp.sum(~pos), 1).astype(jnp.float32),
                         0.0, 1.0)
            out[i, j] = np.asarray(jax.random.bernoulli(rngs[i, j], p,
                                                        (lbl.size,)))
    return out


def _steps(params, mode, batch, dtype, monkeypatch, n_steps, tmp_path):
    """Run `n_steps` of both trainers from `params` on `batch` in `dtype`
    and compare them step by step; float64 checks everything, float32 the
    losses and metrics."""
    wide = dtype == np.float64
    if wide:  # the JAX trainer's backbone in float64 too
        monkeypatch.setattr(jt, "xfeat_forward", functools.partial(
            jb.xfeat_forward, compute_dtype=jnp.float64))
    jcfg = jt.TrainConfig(use_distill=mode == "distill",
                          use_kp_position=mode == "kp_position")
    tcfg = tt.TrainConfig(use_distill=mode == "distill",
                          use_kp_position=mode == "kp_position")

    def cast(v):
        return v.astype(dtype) if v.dtype == np.float32 else v
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    jbatch = {k: jnp.asarray(cast(v)) for k, v in batch.items()}
    tbatch = {k: t(cast(v)) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, r: jt.loss_fn(p, jbatch, r, jcfg), has_aux=True))
    step_fn = jax.jit(lambda s, r: jt.train_step(s, jbatch, r, jcfg))

    jstate = jt.init_train_state(jparams, jcfg)
    tstate = tt.init_train_state(
        jax.tree.map(lambda a: a, params_from_jax(params)) if not wide else
        {k: v for k, v in _to64(params_from_jax(params)).items()}, tcfg)
    small_steps = {k: np.zeros(v.shape, int)
                   for k, v in leaves(params).items()}
    lr = jcfg.lr
    for step in range(1, n_steps + 1):
        key = jax.random.key(step)
        keep = t(_jax_keep_masks(batch, key)) if mode == "distill" else None
        if wide and step > 1:
            # the port's own state gives the same loss; then it takes JAX's
            # state (through a JAX-written checkpoint), so the step below
            # starts from equal parameters and moments
            own = tt.value_and_grad(tstate["params"], tbatch, None, tcfg,
                                    keep)[0]
            jloss = grad_fn(jstate["params"], key)[0][0]
            assert float(own) == pytest.approx(float(jloss), rel=1e-5)
            path = str(tmp_path / f"jax_{step}.npz")
            np.savez(path, **jax_ckpt._flatten(jax.device_get(jstate)))
            tstate = restore_checkpoint(path, tstate)
            small_steps = {k: np.zeros_like(v) for k, v in small_steps.items()}
        if wide:
            (jloss, _), jg = grad_fn(jstate["params"], key)
            tloss, _, tg = tt.value_and_grad(tstate["params"], tbatch, None,
                                             tcfg, keep)
            assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
            jgl, tgl = leaves(jg), leaves(params_to_jax(tg))
            top = max(np.abs(g).max() for g in jgl.values())
            for k, g in jgl.items():
                scale = np.abs(g).max()
                if k in ZERO_GRAD:
                    assert max(scale, np.abs(tgl[k]).max()) <= 1e-6 * top, k
                    small_steps[k] += 1
                else:
                    assert np.abs(tgl[k] - g).max() <= 1e-4 * scale, \
                        (step, k)
                    small_steps[k] += np.abs(g) <= 1e-3 * scale

        jstate, jmet = step_fn(jstate, key)
        tstate, tmet = tt.train_step(tstate, tbatch, None, tcfg, keep)
        for k in jmet:
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                                   abs=1e-7), (step, k)
        if not wide:
            continue
        jp, tp = leaves(jstate["params"]), leaves(params_to_jax(
            tstate["params"]))
        for k, a in jp.items():
            if k.endswith("/mean") or k.endswith("/var"):
                np.testing.assert_allclose(tp[k], a, atol=1e-5, rtol=1e-4,
                                           err_msg=k)
            else:
                tol = 1e-6 + 2 * lr * small_steps[k]
                assert (np.abs(tp[k] - a) <= tol).all(), (step, k)
        adam_j, adam_t = jstate["opt_state"][1], tstate["opt_state"][1]
        assert int(adam_t.count) == int(adam_j.count) == step
        assert int(tstate["opt_state"][2].count) == step
        for name, rel, power in (("mu", 1e-4, 1), ("nu", 2e-4, 2)):
            ja_, ta_ = leaves(getattr(adam_j, name)), leaves(
                params_to_jax(getattr(adam_t, name)))
            top = max(np.abs(a).max() for a in ja_.values())
            for k, a in ja_.items():
                if k in ZERO_GRAD:  # moments of rounding noise
                    assert max(np.abs(a).max(), np.abs(ta_[k]).max()) \
                        <= 1e-6 ** power * top, (step, name, k)
                    continue
                assert np.abs(ta_[k] - a).max() <= rel * max(
                    np.abs(a).max(), 1e-30), (step, name, k)
    assert int(tstate["step"]) == n_steps


def _to64(tree):
    from accelerated_features_tpu_torch.train import optim
    return optim.tree_map(lambda t: t.double(), tree)


def _relu_margin(params, batch, monkeypatch):
    """The smallest |ReLU input| after a BatchNorm in the port's float64
    forward of both images. Gradients of the two packages are comparable
    only away from those kinks: their float64 forwards differ by ~1e-6
    (both normalize the input and take BatchNorm statistics in float32), so
    the batch (numpy seed 4) is one whose every ReLU input keeps 3e-6 from
    0; seed 2 puts one at 1.9e-6, where the packages take it to opposite
    sides and a block3 channel's gradient moves by ~10%."""
    seen = []
    real = tb._batch_norm

    def record(x, *a, **k):
        y = real(x, *a, **k)
        seen.append(float(y.abs().min()))
        return y
    monkeypatch.setattr(tb, "_batch_norm", record)
    p64 = _to64(params_from_jax(params))
    with torch.no_grad():
        for i in (0, 1):
            tb.xfeat_forward(p64, t(batch[f"image{i}"]).double(), train=True,
                             compute_dtype=torch.float64)
    monkeypatch.setattr(tb, "_batch_norm", real)
    return min(seen)


@pytest.mark.parametrize("mode", ["kp_position", "distill", "plain"])
def test_two_train_steps_match_jax(params, mode, monkeypatch, tmp_path):
    """Two steps in float64 on both sides (the JAX package keeps its input
    normalization, BatchNorm statistics and dual-softmax product in
    float32, and so does the port): loss, metrics, gradients, parameters,
    running statistics and Adam moments. The second step starts from the
    JAX package's first-step state, restored into the port from a JAX
    checkpoint, after the port's own state is held to the same loss: a
    gradient near zero may take Adam's first step either way (2 x lr
    apart), and from two such states the next gradients differ by more
    than rounding. In float32 a ReLU whose input lies within rounding of 0
    can decide differently in the two packages, and at this size (128
    samples a channel in block3) one such element moves its channel's
    weight gradient by ~10%, so the float32 run is held on its losses and
    metrics (one step)."""
    batch = _batch(np.random.default_rng(4), mode)
    assert _relu_margin(params, batch, monkeypatch) > 3e-6
    _steps(params, mode, batch, np.float32, monkeypatch, 1, tmp_path)
    with jax.enable_x64(True):
        _steps(params, mode, batch, np.float64, monkeypatch, 2, tmp_path)


def test_run_dry_run_on_the_cpu(tmp_path):
    history = trun.main(["--ckpt_save_path", str(tmp_path / "ck"),
                         "--dry_run", "--device", "cpu", "--training_res",
                         "64,64", "--batch_size", "3", "--max_corrs", "16",
                         "--save_ckpt_every", "4"])
    assert len(history) == 10
    assert all(np.isfinite(h["loss_total"]) for h in history)
    assert history[-1]["loss_total"] < history[0]["loss_total"]
    # beside the checkpoints only the tensorboard log, as in the JAX
    # package, when `tensorboard` imports
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name != "logdir") == [
        "ckpt_00000004.npz", "ckpt_00000008.npz"]
    # resume: the run goes on from step 8 to the dry run's 10 steps
    again = trun.main(["--ckpt_save_path", str(tmp_path / "ck"),
                       "--dry_run", "--device", "cpu", "--training_res",
                       "64,64", "--batch_size", "3", "--max_corrs", "16"])
    assert [h["step"] for h in again] == [9, 10]


def test_run_on_an_image_folder(tmp_path):
    """The 40/60 recipe on a PNG folder: synthetic pairs and rendered
    depth pairs in one batch, two steps, a checkpoint."""
    import cv2
    rng = np.random.default_rng(0)
    folder = tmp_path / "pngs"
    folder.mkdir()
    for i in range(10):
        g = rng.uniform(0, 255, (12, 16, 3)).astype(np.uint8)
        cv2.imwrite(str(folder / f"im{i}.png"),
                    cv2.resize(g, (160, 120), interpolation=cv2.INTER_CUBIC))
    # a depth root without MegaDepth's layout is refused
    with pytest.raises(FileNotFoundError, match="no scene indices"):
        trun.main(["--ckpt_save_path", str(tmp_path / "x"),
                   "--megadepth_root_path", str(folder), "--training_type",
                   "xfeat_megadepth", "--device", "cpu"])
    history = trun.main([
        "--ckpt_save_path", str(tmp_path / "ck"), "--synthetic_root_path",
        str(folder), "--device", "cpu", "--training_res", "192,128",
        "--batch_size", "5", "--max_corrs", "64", "--n_steps", "2",
        "--save_ckpt_every", "1", "--rendered_pairs", "2",])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss_total"]) and h["n_corr"] >= 30
               for h in history)
    assert (tmp_path / "ck" / f"ckpt_{history[-1]['step']:08d}.npz").exists()
