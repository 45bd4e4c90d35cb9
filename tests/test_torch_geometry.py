"""The port's pose path against the JAX package's, on the CPU: the Lie
utilities, the pieces of the batched RANSAC, the whole estimator from
shared samples, the pose metrics and the benchmark harness on the
committed holdout. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.eval import megadepth1500 as jax_md
from accelerated_features_tpu.eval import metrics as jax_metrics
from accelerated_features_tpu.geometry import ransac_tpu as jr
from accelerated_features_tpu.sfm import lie as jax_lie
from accelerated_features_tpu_torch.eval import megadepth1500 as md
from accelerated_features_tpu_torch.eval import metrics
from accelerated_features_tpu_torch.geometry import (get_pose_estimator,
                                                     ransac as tr)
from accelerated_features_tpu_torch.sfm import lie

from torch_support import CKPT, HOLDOUT

K = np.array([[709.95, 0, 400], [0, 709.95, 304], [0, 0, 1]], np.float32)


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def scene(seed, n=300, outliers=0.3, noise=0.5):
    """Seeded two-view scene: pixel correspondences (n,2) x2 with `noise`
    px of Gaussian noise and a share of uniform outliers, the true (R, t)
    and the true inlier mask."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2.2, 2.2, n),
                  rng.uniform(3, 12, n)], -1)
    R = rodrigues(rng.normal(size=3) * 0.12)
    t = np.array([rng.choice([-1.0, 1.0]), 0, 0]) + rng.normal(size=3) * 0.3
    Kd = K.astype(np.float64)

    def project(P):
        uv = P @ Kd.T
        return uv[:, :2] / uv[:, 2:]

    p0 = project(X) + rng.normal(size=(n, 2)) * noise
    p1 = project(X @ R.T + t) + rng.normal(size=(n, 2)) * noise
    bad = rng.uniform(size=n) < outliers
    p1[bad] = np.stack([rng.uniform(0, 800, bad.sum()),
                        rng.uniform(0, 608, bad.sum())], -1)
    return (p0.astype(np.float32), p1.astype(np.float32), R,
            t / np.linalg.norm(t), ~bad)


def normalized(seed, n=200):
    p0, p1, R, t, good = scene(seed, n)
    x0 = (p0 - K[:2, 2]) / K[0, 0]
    x1 = (p1 - K[:2, 2]) / K[0, 0]
    return x0, x1, R, t, good


def angle_deg(a, b):
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def rot_angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2,
                                        -1, 1)))


# ---- sfm/lie ---------------------------------------------------------------

def test_so3_exp_log_match_jax():
    """Rodrigues and its inverse on random, tiny and zero rotations;
    float32 arithmetic in both, tolerance 1e-4 (measured ~1e-6)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(20, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] *= 1e-9
    w[2] *= 1e-3
    R_ref = np.asarray(jax_lie.so3_exp(jnp.asarray(w)))
    R = lie.so3_exp(t32(w))
    np.testing.assert_allclose(R.numpy(), R_ref, atol=1e-4)
    np.testing.assert_allclose(lie.so3_log(R).numpy(),
                               np.asarray(jax_lie.so3_log(jnp.asarray(R_ref))),
                               atol=1e-4)


@pytest.mark.parametrize("name", ["rotate", "se3_apply", "se3_matrix",
                                  "se3_inverse", "se3_compose"])
def test_se3_utilities_match_jax(name):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(7, 6)).astype(np.float32)
    b = rng.normal(size=(7, 6)).astype(np.float32)
    a[0, :3] = 0.0  # the small-angle branch
    args = {"rotate": (a[:, :3], b[:, :3]), "se3_apply": (a, b[:, :3]),
            "se3_matrix": (a,), "se3_inverse": (a,),
            "se3_compose": (a, b)}[name]
    ref = np.asarray(getattr(jax_lie, name)(*map(jnp.asarray, args)))
    got = getattr(lie, name)(*map(t32, args)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


# ---- the pieces of the RANSAC ----------------------------------------------

def test_eight_point_matches_jax_up_to_sign_and_scale():
    """E from eight exact correspondences, over a batch of minimal
    samples. The null vector's sign is the SVD's choice, so both are
    brought to unit Frobenius norm and the same sign; then 1e-4."""
    x0, x1, *_ = normalized(2, n=64)
    x0, x1 = x0.reshape(8, 8, 2), x1.reshape(8, 8, 2)
    got = tr._eight_point(t32(x0), t32(x1)).numpy()
    for i in range(8):
        ref = np.asarray(jr._eight_point(jnp.asarray(x0[i]),
                                         jnp.asarray(x1[i])))
        a = got[i] / np.linalg.norm(got[i])
        b = ref / np.linalg.norm(ref)
        b = b * np.sign(np.sum(a * b))
        np.testing.assert_allclose(a, b, atol=1e-4)
        s = np.linalg.svd(got[i], compute_uv=False)
        assert abs(s[0] - s[1]) < 1e-5 * s[0] and s[2] < 1e-5 * s[0]


def test_sampson_errors_match_jax():
    x0, x1, R, t, _ = normalized(3)
    E = np.asarray(jr._pose_to_E(jax_lie.so3_log(jnp.asarray(R, jnp.float32)),
                                 jnp.asarray(t, jnp.float32)))
    got_E = tr._pose_to_E(lie.so3_log(t32(R)), t32(t)).numpy()
    np.testing.assert_allclose(got_E, E, atol=1e-5)
    for name in ("_sampson_sq", "_sampson_signed"):
        ref = np.asarray(getattr(jr, name)(jnp.asarray(E), jnp.asarray(x0),
                                           jnp.asarray(x1)))
        got = getattr(tr, name)(t32(E), t32(x0), t32(x1)).numpy()
        # relative: outliers' errors are orders above the inliers'
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)


def test_recover_pose_matches_jax():
    x0, x1, R, t, good = normalized(4)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    w = good.astype(np.float32)
    for sign in (1.0, -1.0):  # E is known up to sign
        E = (sign * tx @ R).astype(np.float32)
        R_ref, t_ref = jr._recover_pose(jnp.asarray(E), jnp.asarray(x0),
                                        jnp.asarray(x1), jnp.asarray(w))
        R_got, t_got = tr._recover_pose(t32(E), t32(x0), t32(x1), t32(w))
        np.testing.assert_allclose(R_got.numpy(), np.asarray(R_ref),
                                   atol=1e-4)
        np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref),
                                   atol=1e-4)
        assert rot_angle_deg(R_got.numpy().astype(np.float64), R) < 0.05
        assert angle_deg(t_got.numpy(), t) < 0.05


def test_refine_pose_sampson_matches_jax():
    """Eight Gauss-Newton steps from a perturbed pose, on two pairs at
    once in the port (batch dimension) and one by one in JAX; 1e-4 on the
    angle-axis and on the unit translation."""
    rng = np.random.default_rng(5)
    batch = []
    for seed in (5, 6):
        x0, x1, R, t, good = normalized(seed)
        w0 = np.asarray(jax_lie.so3_log(jnp.asarray(R, jnp.float32)))
        batch.append((w0 + rng.normal(size=3).astype(np.float32) * 0.02,
                      (t + rng.normal(size=3) * 0.05).astype(np.float32),
                      x0, x1, good.astype(np.float32)))
    got_w, got_t = tr._refine_pose_sampson(
        *(t32(np.stack([b[i] for b in batch])) for i in range(5)))
    for i, b in enumerate(batch):
        ref_w, ref_t = jr._refine_pose_sampson(*map(jnp.asarray, b))
        np.testing.assert_allclose(got_w[i].numpy(), np.asarray(ref_w),
                                   atol=1e-4)
        np.testing.assert_allclose(got_t[i].numpy(), np.asarray(ref_t),
                                   atol=1e-4)


# ---- the whole estimator ---------------------------------------------------

def jax_samples(valid, n_hypotheses, key):
    """The 8-subsets exactly as `ransac_essential_tpu` draws them."""
    n = valid.shape[0]
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n_hypotheses)
    return np.asarray(jax.vmap(lambda k: jax.lax.top_k(
        logits + jax.random.gumbel(k, (n,)), 8)[1])(keys))


@pytest.mark.parametrize("seed,n_real", [(10, 256), (11, 200)])
def test_ransac_from_shared_samples_matches_jax(seed, n_real):
    """Samples drawn with `jax.random` as the JAX estimator draws them go
    to the port's `_ransac_from_samples`; the result is held against
    `ransac_essential_tpu` with the same key: rotation within 0.1 deg,
    translation direction within 0.2 deg, inlier masks equal on >= 99% of
    the rows (both float32; SVD and summation orders differ)."""
    p0, p1, R, t, good = scene(seed, 256)
    valid = np.arange(256) < n_real
    key = jax.random.key(seed)
    ref = jr.ransac_essential_tpu(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(K), jnp.asarray(K),
        jnp.asarray(valid), 2.5, n_hypotheses=128, key=key)
    samples = jax_samples(valid, 128, key)
    x0 = tr._normalize(t32(p0)[None], t32(K)[None])
    x1 = tr._normalize(t32(p1)[None], t32(K)[None])
    thr_sq = torch.tensor([(2.5 / K[0, 0]) ** 2], dtype=torch.float32)
    got = tr._ransac_from_samples(x0, x1, torch.tensor(valid)[None],
                                  torch.tensor(samples)[None].long(), thr_sq)
    R_got, t_got = got.R[0].numpy(), got.t[0].numpy()
    assert rot_angle_deg(R_got, np.asarray(ref.R)) < 0.1
    assert angle_deg(t_got, np.asarray(ref.t)) < 0.2
    same = (got.inliers[0].numpy() == np.asarray(ref.inliers)).mean()
    assert same >= 0.99
    assert int(got.num_inliers[0]) == int(got.inliers[0].sum())
    assert not got.inliers[0, n_real:].any()
    # and both found the scene's pose
    assert rot_angle_deg(R_got.astype(np.float64), R) < 1.0
    assert angle_deg(t_got, t) < 3.0


def test_ransac_batch_recovers_pose_and_inliers():
    """Four pairs in one call at the default 512 hypotheses, samples from
    a torch.Generator: every pose within 1 deg / 3 deg of the truth and
    >= 90% of the true inliers found; the same generator seed gives the
    same result."""
    scenes = [scene(s, 256) for s in (20, 21, 22, 23)]
    p0 = t32(np.stack([s[0] for s in scenes]))
    p1 = t32(np.stack([s[1] for s in scenes]))
    Ks = t32(K)[None].expand(4, 3, 3)

    def run():
        return tr.ransac_essential_batch(
            p0, p1, Ks, Ks, generator=torch.Generator().manual_seed(3))
    res, again = run(), run()
    assert torch.equal(res.inliers, again.inliers)
    for i, (_, _, R, t, good) in enumerate(scenes):
        assert rot_angle_deg(res.R[i].numpy().astype(np.float64), R) < 1.0
        assert angle_deg(res.t[i].numpy(), t) < 3.0
        found = res.inliers[i].numpy()
        assert (found & good).sum() >= 0.9 * good.sum()
    one = tr.ransac_essential(p0[0], p1[0], Ks[0], Ks[0], n_hypotheses=128,
                              generator=torch.Generator().manual_seed(3))
    assert one.R.shape == (3, 3) and one.inliers.shape == (256,)


def test_draw_samples_are_subsets_of_valid_rows():
    valid = torch.zeros((2, 40), dtype=torch.bool)
    valid[0, :20] = True
    valid[1, 5:] = True
    s = tr._draw_samples(valid, 64, torch.Generator().manual_seed(0))
    assert s.shape == (2, 64, 8)
    assert bool(torch.gather(valid[:, None].expand(2, 64, 40), 2, s).all())
    assert all(len(set(row.tolist())) == 8 for row in s.reshape(-1, 8))


def test_pose_estimator_registry_and_host_contract():
    p0, p1, R, t, good = scene(30, 300)
    R_pk, t_pk, mask_pk = get_pose_estimator("posekit")(p0, p1, K, K)
    assert R_pk.shape == (3, 3) and t_pk.shape == (3,)
    assert mask_pk.dtype == bool and mask_pk.shape == (300,)
    assert get_pose_estimator() is get_pose_estimator("posekit")
    with pytest.raises(ValueError):
        get_pose_estimator("tpu")
    est = get_pose_estimator("gpu", device="cpu")
    assert est(p0[:7], p1[:7], K, K) is None
    R_got, t_got, mask = est(p0, p1, K, K, max_epipolar_error=2.5)
    assert R_got.dtype == np.float64 and mask.shape == (300,)
    assert rot_angle_deg(R_got, R) < 1.0 and angle_deg(t_got, t) < 3.0
    assert tr._pad_bucket(300) == jr._pad_bucket(300) == 512
    assert tr._pad_bucket(10) == jr._pad_bucket(10) == 256


def test_pose_estimator_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p0, p1, *_ = scene(31, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_pose_estimator("gpu")(p0, p1, K, K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        md.make_matcher("xfeat")


# ---- eval ------------------------------------------------------------------

def test_relative_pose_error_equals_jax():
    rng = np.random.default_rng(40)
    for _ in range(5):
        T = np.eye(4)
        T[:3, :3] = rodrigues(rng.normal(size=3))
        T[:3, 3] = rng.normal(size=3)
        R_est = rodrigues(rng.normal(size=3))
        t_est = rng.normal(size=3)
        ref = jax_metrics.relative_pose_error(T, R_est, t_est)
        got = metrics.relative_pose_error(T, R_est, t_est)
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-12
    zero = metrics.relative_pose_error(T, R_est, np.zeros(3))
    assert zero == jax_metrics.relative_pose_error(T, R_est, np.zeros(3))


@pytest.mark.parametrize("name", ["error_auc", "mean_accuracy",
                                  "pose_errors_to_summary"])
def test_pose_summaries_equal_jax(name):
    rng = np.random.default_rng(41)
    errs = list(rng.gamma(1.5, 6.0, 60)) + [np.inf, 180.0]
    arg = [{"R_err": e, "t_err": e / 2} for e in errs] \
        if name == "pose_errors_to_summary" else errs
    ref = getattr(jax_metrics, name)(arg)
    got = getattr(metrics, name)(arg)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-12


def test_run_benchmark_precomputed_on_seeded_scenes():
    scenes = [scene(s, 300) for s in (50, 51, 52)]
    pairs = []
    for _, _, R, t, _ in scenes:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        pairs.append({"K0": K.tolist(), "K1": K.tolist(),
                      "T_0to1": T.tolist()})
    out = md.run_benchmark_precomputed([(s[0], s[1]) for s in scenes], pairs,
                                       pose_backend="gpu", device="cpu")
    assert out["n_pairs"] == 3 and out["acc@5"] == 1.0
    few = md.compute_pose_error(pairs[0], scenes[0][0][:4], scenes[0][1][:4],
                                device="cpu")
    assert few["R_err"] == 180.0 and few["n_inliers"] == 0


def test_run_benchmark_on_holdout_matches_jax(monkeypatch):
    """Three pairs of the committed rendered holdout through
    `run_benchmark(make_matcher("xfeat"))` in both packages, top_k 1024,
    pose backend `gpu` (on the CPU) against `tpu`: the same matched pairs
    as sets. The two estimators draw different samples, so a pair's pose
    errors are compared (within 1 deg) with the port's estimator fed the
    samples JAX draws for that pair. Over seeds both estimators spread by
    several degrees on these pairs (the third has few inliers), so the
    port's own draw is only held to returning a pose."""
    pytest.importorskip("cv2")
    json_path = str(HOLDOUT / "rendered_pose_pairs.json")
    seen = {"jax": [], "torch": []}

    def recording(fn, key):
        def wrapped(im0, im1):
            mk0, mk1 = fn(im0, im1)
            seen[key].append((mk0, mk1))
            return mk0, mk1
        return wrapped

    errs = {"jax": [], "torch": []}
    real_jax, real_torch = jax_md.compute_pose_error, md.compute_pose_error
    monkeypatch.setattr(jax_md, "compute_pose_error", lambda *a, **k: (
        errs["jax"].append(real_jax(*a, **k)) or errs["jax"][-1]))
    monkeypatch.setattr(md, "compute_pose_error", lambda *a, **k: (
        errs["torch"].append(real_torch(*a, **k)) or errs["torch"][-1]))
    ref = jax_md.run_benchmark(
        recording(jax_md.make_matcher("xfeat", 1024, CKPT), "jax"),
        str(HOLDOUT), json_path, limit=3, progress=False,
        pose_backend="tpu")
    got = md.run_benchmark(
        recording(md.make_matcher("xfeat", 1024, CKPT, device="cpu"),
                  "torch"),
        str(HOLDOUT), json_path, limit=3, progress=False,
        pose_backend="gpu", device="cpu")
    assert got["n_pairs"] == ref["n_pairs"] == 3
    assert got["mean_matches"] == ref["mean_matches"]
    for a, b in zip(seen["torch"], seen["jax"]):
        assert len(a[0]) > 100
        assert ({tuple(r) for r in np.concatenate(a, 1).tolist()}
                == {tuple(r) for r in np.concatenate(b, 1).tolist()})
    for e in errs["torch"]:
        assert max(e["R_err"], e["t_err"]) < 180.0 and e["n_inliers"] >= 5

    pairs = md.load_pairs(json_path)[:3]
    for pair, (mk0, mk1), e_ref in zip(pairs, seen["jax"], errs["jax"]):
        n, m = len(mk0), tr._pad_bucket(len(mk0))
        p0, p1 = np.zeros((2, m, 2), np.float32)
        p0[:n], p1[:n] = mk0, mk1
        valid = np.arange(m) < n
        K0, K1 = t32(pair["K0"])[None], t32(pair["K1"])[None]
        samples = jax_samples(valid, 512, jax.random.key(0))
        thr_sq = (2.5 / ((K0[:, 0, 0] + K0[:, 1, 1] + K1[:, 0, 0]
                          + K1[:, 1, 1]) / 4.0)) ** 2
        res = tr._ransac_from_samples(
            tr._normalize(t32(p0)[None], K0), tr._normalize(t32(p1)[None], K1),
            torch.tensor(valid)[None], torch.tensor(samples)[None].long(),
            thr_sq)
        e = metrics.relative_pose_error(
            np.asarray(pair["T_0to1"], np.float64),
            res.R[0].double().numpy(), res.t[0].double().numpy())
        assert abs(e["R_err"] - e_ref["R_err"]) < 1.0
        assert abs(e["t_err"] - e_ref["t_err"]) < 1.0
        assert abs(int(res.num_inliers[0]) - e_ref["n_inliers"]) \
            <= 0.02 * n


def test_run_benchmark_batched_posekit_pool_equals_one_process():
    """`workers=2` runs posekit in a spawn pool of two processes and gives
    the summary of `workers=0`, value for value; the device backend
    refuses a pool."""
    json_path = str(HOLDOUT / "rendered_pose_pairs.json")
    kw = dict(top_k=512, weights=CKPT, batch_size=4, limit=4,
              progress=False, device="cpu")
    one = md.run_benchmark_batched(str(HOLDOUT), json_path, workers=0, **kw)
    pool = md.run_benchmark_batched(str(HOLDOUT), json_path, workers=2, **kw)
    assert one.keys() == pool.keys() and one["n_pairs"] == 4
    keys = sorted(one)
    assert np.array_equal([one[k] for k in keys], [pool[k] for k in keys])
    with pytest.raises(ValueError, match="workers <= 1"):
        md.run_benchmark_batched(str(HOLDOUT), json_path, workers=2,
                                 pose_backend="gpu", **kw)


def test_run_benchmark_batched_equals_per_pair():
    """Two holdout pairs, top_k 1024, on the CPU: size-bucketed batched
    extraction and the batched masked MNN give the per-pair path's matches
    (same count, same order), so the pose summary is the same; bfloat16 is
    passed down to the batched extraction."""
    pytest.importorskip("cv2")
    json_path = str(HOLDOUT / "rendered_pose_pairs.json")
    per_pair = md.run_benchmark(
        md.make_matcher("xfeat", 1024, CKPT, device="cpu"), str(HOLDOUT),
        json_path, limit=2, progress=False, pose_backend="gpu",
        device="cpu")
    batched = md.run_benchmark_batched(
        str(HOLDOUT), json_path, top_k=1024, weights=CKPT, batch_size=3,
        limit=2, progress=False, pose_backend="gpu", device="cpu")
    assert batched["n_pairs"] == 2
    assert batched["mean_matches"] == per_pair["mean_matches"] > 100
    assert batched["mean_inliers"] == per_pair["mean_inliers"]
    for k in ("auc@5", "auc@10", "auc@20"):
        assert abs(batched[k] - per_pair[k]) < 1e-9
    bf16 = md.run_benchmark_batched(
        str(HOLDOUT), json_path, top_k=1024, weights=CKPT, batch_size=3,
        limit=2, progress=False, pose_backend="gpu", device="cpu",
        compute_dtype=torch.bfloat16, fused_stem=True)
    assert abs(bf16["mean_matches"] - per_pair["mean_matches"]) \
        < 0.1 * per_pair["mean_matches"]
