"""The port's multi-GPU layer (`parallel/`, `train.trainer.
make_sharded_train_step`) on gloo process groups of 2 and 4 CPU ranks,
the cases of `tests/test_parallel.py` one for one, each held against its
single-device counterpart.

One spawned group a world size runs every case of that size
(`_rank_cases`, a module fixture), so the file spawns three groups (2
ranks, 4 ranks, and the dry run's 4), each under its own time limit.

Tolerances:
- the sharded step against the port's single-device step, in float64:
  the loss and metrics within 1e-6 relative (BatchNorm statistics are
  float32 sums, added in another order across ranks, and the metrics are
  float32: a few ulps); parameters within
  1e-6, plus 2 x lr where the single-device gradient is below 1e-3 of its
  leaf's largest (Adam's first step moves an element by ~lr whatever its
  gradient's size, so a near-zero gradient may take either sign; the
  biases right before a BatchNorm have only such gradients); running
  statistics within 1e-6 + 1e-5 relative; Adam's mu within 1e-5 and nu
  within 2e-5 of their leaf's largest (float32 BatchNorm statistics move
  a gradient by ~1e-6 of its size);
- the sharded step against the JAX package's single-device step in
  float64: `tests/test_torch_train_step.py`'s tolerances;
- extraction: each image shares >= 95% of its keypoints with one call on
  the whole batch, their scores and descriptors within 1e-5 (a rank's
  convolutions run on fewer images and threads and may round a score
  otherwise, moving a keypoint tied with its neighbour); MNN and
  LighterGlue: matches equal, LighterGlue's scores within 1e-4 (JAX's
  `test_parallel.py`); bundle adjustment: the final cost
  within 1e-5 relative, cameras and points within 2e-3 + 1e-3 relative
  (JAX's).
"""

import sys

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.parallel.dryrun import run_ranks

B, H, W, M = 2, 64, 64, 32
LR = 3e-4
# biases right before a BatchNorm: zero gradient in exact arithmetic
ZERO_GRAD = {f"fine_matcher/{i}/b" for i in range(4)}
TIMEOUT = 240.0


# ---- inputs made in the parent, numpy only --------------------------------

def _jax_params():
    """The JAX package's extractor init (key 0), `tests/
    test_torch_train_step.py`'s parameters, as numpy."""
    import jax

    from accelerated_features_tpu.models.params import init_xfeat_params
    return jax.tree.map(np.asarray,
                        jax.jit(init_xfeat_params)(jax.random.key(0)))


class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def _batch(mode, n=B, seed=4):
    """`tests/test_torch_train_step.py`'s batch of `n` pairs (numpy seed 4:
    every ReLU input of the float64 forward keeps 3e-6 from 0 with
    `_jax_params`, asserted by the `inputs` fixture)."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from test_torch_train_step import _batch as step_batch
    import test_torch_train_step as tts
    old = tts.B
    tts.B = n
    try:
        return step_batch(np.random.default_rng(seed), mode)
    finally:
        tts.B = old


def _wide(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in batch.items()}


def _ba_problem(seed=0, C=8, Pn=200, N=1200):
    """`tests/test_parallel.py`'s random problem, two cameras fixed."""
    rng = np.random.default_rng(seed)
    cams = rng.normal(0, 0.1, (C, 6)).astype(np.float32)
    cams[:, 5] += 4
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    return {"cams": cams,
            "points": rng.uniform(-2, 2, (Pn, 3)).astype(np.float32),
            "K": np.array([[500., 0, 320], [0, 500., 240], [0, 0, 1]],
                          np.float32),
            "obs_cam": rng.integers(0, C, N),
            "obs_pt": rng.integers(0, Pn, N),
            "obs_uv": rng.uniform(0, 480, (N, 2)).astype(np.float32),
            "obs_mask": rng.uniform(size=N) > 0.1, "fixed_cams": fixed}


def _port_problem(a):
    from accelerated_features_tpu_torch.sfm.ba import BAProblem
    return BAProblem(**{k: torch.from_numpy(np.asarray(v))
                        for k, v in a.items()})


def _lg_inputs():
    rng = np.random.default_rng(0)
    b, m, n = 1, 128, 160
    return {"kpts0": rng.uniform(0, 600, (b, m, 2)).astype(np.float32),
            "kpts1": rng.uniform(0, 600, (b, n, 2)).astype(np.float32),
            "descs0": rng.normal(size=(b, m, 64)).astype(np.float32),
            "descs1": rng.normal(size=(b, n, 64)).astype(np.float32),
            "size0": np.array([[640.0, 480.0]], np.float32),
            "size1": np.array([[640.0, 480.0]], np.float32),
            "mask0": np.arange(m)[None] < m - 24,    # padded tails
            "mask1": np.arange(n)[None] < n - 16}


def _mnn_inputs():
    rng = np.random.default_rng(1)
    d1 = rng.normal(size=(96, 64)).astype(np.float32)
    d2 = rng.normal(size=(128, 64)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return {"d1": d1, "d2": d2, "v1": rng.uniform(size=96) > 0.2,
            "v2": rng.uniform(size=128) > 0.2}


def _lg_weights():
    from pathlib import Path

    from accelerated_features_tpu_torch.models.params import \
        load_lighterglue_params
    from accelerated_features_tpu_torch.train import optim
    path = Path(__file__).resolve().parents[1] / "artifacts" / \
        "lighterglue_ft_ckpt7791.npz"
    return optim.tree_map(lambda t: t.numpy(),
                          load_lighterglue_params(str(path)))


# ---- what each rank runs ---------------------------------------------------

def _tree_np(tree):
    from accelerated_features_tpu_torch.train import optim
    return optim.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _tree_t(tree):
    from accelerated_features_tpu_torch.train import optim
    return optim.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree) \
        if not isinstance(tree, np.ndarray) else torch.from_numpy(tree)


def _step_case(shape, jparams, batch, mode, clip=1.0, keep=None):
    from accelerated_features_tpu_torch.models.params import params_from_jax
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    from accelerated_features_tpu_torch.train import optim
    from accelerated_features_tpu_torch.train import trainer as tt
    mesh = make_mesh(shape)
    cfg = tt.TrainConfig(use_distill=mode == "distill",
                         use_kp_position=mode == "kp_position",
                         grad_clip=clip)
    params = optim.tree_map(lambda t: t.double(), params_from_jax(jparams))
    state = tt.init_train_state(params, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step_fn, sharded, shard_batch = tt.make_sharded_train_step(
        mesh, state, tb, cfg)
    gen = torch.Generator().manual_seed(3)
    new, metrics = step_fn(sharded, shard_batch(tb), gen,
                           None if keep is None else torch.from_numpy(keep))
    local = {k: tuple(v.shape) for k, v in shard_batch(tb).items()}
    return {"state": _tree_np(tt.gather_state(mesh, new)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "local_shapes": local,
            "fm0_w_local": tuple(new["params"]["fine_matcher"][0]["w"].shape)}


def _extract_case(shape, jparams, images):
    from accelerated_features_tpu_torch.models.params import (fold_batchnorm,
                                                              params_from_jax)
    from accelerated_features_tpu_torch.parallel.matching import \
        sharded_detect_and_compute
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(shape)
    params = params_from_jax(fold_batchnorm(jparams))
    out = sharded_detect_and_compute(mesh, params, torch.from_numpy(images),
                                     top_k=64, detection_threshold=0.012)
    return {k: v.numpy() for k, v in out.items()}


def _mnn_case(shape, inp):
    from accelerated_features_tpu_torch.parallel.matching import mnn_match_sp
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(shape)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = []
    for gate in (0.1, -1.0):
        idx, mask = mnn_match_sp(mesh, t["d1"], t["d2"], t["v1"], t["v2"],
                                 min_cossim=gate)
        out.append((idx.numpy(), mask.numpy()))
    return out


def _lg_case(shape, weights, inp):
    from accelerated_features_tpu_torch.parallel.lighterglue_sp import \
        lighterglue_forward_sp
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(shape)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    m0, s0 = lighterglue_forward_sp(mesh, _tree_t(weights), **t)
    return m0.numpy(), s0.numpy()


def _ba_case(shape, prob, point):
    from accelerated_features_tpu_torch.parallel import ba as pba
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(shape)
    fn = pba.bundle_adjust_point_sharded if point else \
        pba.bundle_adjust_sharded
    solved, stats = fn(_port_problem(prob), mesh, iters=5, cg_iters=20)
    return (solved.cams.numpy(), solved.points.numpy(),
            {k: float(v) for k, v in stats.items()})


def _mesh_case(shape):
    from accelerated_features_tpu_torch.parallel import replicate, shard_on
    from accelerated_features_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(shape)
    rank = mesh.rank
    mine = torch.full((4, 6), float(rank))
    return {"shape": dict(mesh.shape), "coords": dict(mesh.coords),
            "replicated": replicate(mesh, mine).numpy(),
            "data_shard": shard_on(mesh, torch.arange(8.0)).numpy(),
            "model_shard": shard_on(mesh, torch.arange(12.0).reshape(2, 6),
                                    "model", 1).numpy()}


def _cli_case(ck):
    # no tensorboard writer (its import is the run's slowest part here)
    sys.modules["torch.utils.tensorboard"] = None
    from accelerated_features_tpu_torch.train import run
    hist = run.main(["--ckpt_save_path", ck, "--dry_run", "--batch_size",
                     "7", "--n_steps", "1", "--training_res", "64,64",
                     "--max_corrs", "32", "--save_ckpt_every", "1",
                     "--device", "cpu"])
    return [h["loss_total"] for h in hist]


def _rank_cases(rank, cases):
    """Every case in turn on this rank: {name: result}."""
    out = {}
    for name, fn, args in cases:
        out[name] = globals()[fn](*args)
    return out


# ---- the spawned groups ----------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    from test_torch_train_step import _relu_margin
    jparams = _jax_params()
    rng = np.random.default_rng(0)
    distill = _batch("distill")
    assert _relu_margin(jparams, distill, _Patch()) > 3e-6
    return {"jparams": jparams, "distill": _wide(distill),
            "kp": _wide(_batch("kp_position")),
            "images": rng.uniform(0, 1, (8, 64, 96, 1)).astype(np.float32),
            "mnn": _mnn_inputs(), "lg": _lg_inputs(),
            "lg_w": _lg_weights(), "ba": _ba_problem()}


@pytest.fixture(scope="module")
def keep_masks(inputs):
    """JAX's keep-masks of the distillation for key 1 (B, 2, h*w)."""
    import jax
    from test_torch_train_step import _jax_keep_masks
    return _jax_keep_masks(inputs["distill"], jax.random.key(1))


@pytest.fixture(scope="module")
def two(inputs):
    i = inputs
    cases = [
        ("mesh_2x1", "_mesh_case", ((2, 1),)),
        ("mesh_1x2", "_mesh_case", ((1, 2),)),
        ("step_2x1", "_step_case", ((2, 1), i["jparams"], i["distill"],
                                    "distill")),
        ("step_1x2", "_step_case", ((1, 2), i["jparams"], i["kp"],
                                    "kp_position", 0.01)),
        ("extract_2x1", "_extract_case", ((2, 1), i["jparams"],
                                          i["images"])),
        ("mnn_1x2", "_mnn_case", ((1, 2), i["mnn"])),
        ("lg_1x2", "_lg_case", ((1, 2), i["lg_w"], i["lg"])),
        ("ba_2x1", "_ba_case", ((2, 1), i["ba"], False)),
        ("ba_point_2x1", "_ba_case", ((2, 1), i["ba"], True)),
        ("mnn_ties", "_mnn_case", ((1, 2), _tie_inputs())),
    ]
    return run_ranks(_rank_cases, 2, cases, device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def four(inputs, keep_masks, tmp_path_factory):
    i = inputs
    ck = str(tmp_path_factory.mktemp("cli"))
    cases = [
        ("mesh_2x2", "_mesh_case", ((2, 2),)),
        ("step_2x2_kp", "_step_case", ((2, 2), i["jparams"], i["kp"],
                                       "kp_position")),
        ("step_2x2_distill", "_step_case", ((2, 2), i["jparams"],
                                            i["distill"], "distill", 1.0,
                                            keep_masks)),
        ("step_2x2_clip", "_step_case", ((2, 2), i["jparams"], i["kp"],
                                         "kp_position", 0.01)),
        ("extract_4x1", "_extract_case", ((4, 1), i["jparams"],
                                          i["images"])),
        ("mnn_2x2", "_mnn_case", ((2, 2), i["mnn"])),
        ("mnn_1x4", "_mnn_case", ((1, 4), i["mnn"])),
        ("lg_1x4", "_lg_case", ((1, 4), i["lg_w"], i["lg"])),
        ("ba_point_4x1", "_ba_case", ((4, 1), i["ba"], True)),
        ("cli_batch7", "_cli_case", (ck,)),
    ]
    return run_ranks(_rank_cases, 4, cases, device="cpu", timeout=TIMEOUT)


# ---- single-device references ----------------------------------------------

def _port_step(jparams, batch, mode, clip=1.0, keep=None):
    from accelerated_features_tpu_torch.models.params import params_from_jax
    from accelerated_features_tpu_torch.train import optim
    from accelerated_features_tpu_torch.train import trainer as tt
    cfg = tt.TrainConfig(use_distill=mode == "distill",
                         use_kp_position=mode == "kp_position",
                         grad_clip=clip)
    params = optim.tree_map(lambda t: t.double(), params_from_jax(jparams))
    state = tt.init_train_state(params, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kn = None if keep is None else torch.from_numpy(keep)
    _, _, grads = tt.value_and_grad(params, tb,
                                    torch.Generator().manual_seed(3), cfg,
                                    kn)
    new, metrics = tt.train_step(state, tb, torch.Generator().manual_seed(3),
                                 cfg, kn)
    return _tree_np(new), {k: float(v) for k, v in metrics.items()}, \
        _tree_np(grads)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _params_close(got, ref, grads, rel_stats=1e-5, atol_stats=1e-6):
    """Parameters within 1e-6 + 2 lr where the gradient is near zero;
    running statistics within atol_stats + rel_stats relative."""
    g = _leaves(grads)
    got, ref = _leaves(got), _leaves(ref)
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if k.endswith("/mean") or k.endswith("/var"):
            np.testing.assert_allclose(got[k], r, atol=atol_stats,
                                       rtol=rel_stats, err_msg=k)
            continue
        small = np.abs(g[k]) <= 1e-3 * np.abs(g[k]).max()
        if k in ZERO_GRAD:   # all rounding noise
            small = np.ones_like(small)
        tol = 1e-6 + 2 * LR * small
        assert (np.abs(got[k] - r) <= tol).all(), k


def _check_step(res, jparams, batch, mode, clip=1.0, keep=None):
    ref, rmet, grads = _port_step(jparams, batch, mode, clip, keep)
    for k, v in rmet.items():   # float32 metrics: a few ulps
        assert res["metrics"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    _params_close(res["state"]["params"], ref["params"], grads)
    for name, rel in (("mu", 1e-5), ("nu", 2e-5)):
        a = _leaves(getattr(res["state"]["opt_state"][1], name))
        b = _leaves(getattr(ref["opt_state"][1], name))
        top = max(np.abs(v).max() for v in b.values())
        for k in b:
            if k in ZERO_GRAD:   # moments of rounding noise
                continue
            scale = max(np.abs(b[k]).max(), 1e-300)
            assert np.abs(a[k] - b[k]).max() <= rel * scale + 1e-12 * top, \
                (name, k)
    assert int(res["state"]["step"]) == 1


# ---- tests ---------------------------------------------------------------

def test_mesh_shapes(two, four):
    from accelerated_features_tpu_torch.parallel import make_mesh
    solo = make_mesh()
    assert solo.shape == {"data": 1, "model": 1} and solo.active
    with pytest.raises(ValueError):
        make_mesh((2, 1))          # one process, no group
    for r, out in enumerate(f["mesh_2x2"] for f in four):
        assert out["shape"] == {"data": 2, "model": 2}
        assert out["coords"] == {"data": r // 2, "model": r % 2}
        # replicate: the rank at coordinate 0 of both axes
        assert (out["replicated"] == 0).all()
        assert out["data_shard"].tolist() == [4.0 * (r // 2) + j
                                              for j in range(4)]
        assert out["model_shard"].shape == (2, 3)
    for r, out in enumerate(f["mesh_1x2"] for f in two):
        assert out["shape"] == {"data": 1, "model": 2}
        assert out["coords"] == {"data": 0, "model": r}
        assert out["data_shard"].tolist() == list(range(8))


def test_dryrun_multigpu_entrypoint():
    from accelerated_features_tpu_torch.parallel.dryrun import \
        dryrun_multigpu
    out = dryrun_multigpu(4, timeout=TIMEOUT, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2} and out["step"] == 1
    assert np.isfinite(out["loss"]) and out["sp_mnn"] > 0


@pytest.mark.parametrize("case,mode,clip", [
    ("step_2x1", "distill", 1.0), ("step_1x2", "kp_position", 0.01),
    ("step_2x2_kp", "kp_position", 1.0), ("step_2x2_clip", "kp_position",
                                          0.01)])
def test_sharded_step_matches_single_device(inputs, two, four, case, mode,
                                            clip):
    """Data parallelism (global BatchNorm statistics, gradients summed over
    'data', the generator's keep-masks), tensor parallelism (the fine
    matcher's shards and the clip over them: clip 0.01 is active here) and
    both, against the port's single-device step on the global batch."""
    res = (two if case in two[0] else four)
    batch = inputs["distill" if mode == "distill" else "kp"]
    for r in res[1:]:   # every rank holds the same whole state
        for a, b in zip(_leaves(r[case]["state"]).values(),
                        _leaves(res[0][case]["state"]).values()):
            assert np.array_equal(a, b)
    _check_step(res[0][case], inputs["jparams"], batch, mode, clip)
    shapes = res[0][case]["local_shapes"]
    d = 1 if case == "step_1x2" else 2
    assert shapes["image0"][0] == B // d
    m = 1 if case == "step_2x1" else 2
    assert res[0][case]["fm0_w_local"] == (512 // m, 128)


def test_sharded_step_with_given_keep_masks(inputs, four, keep_masks):
    _check_step(four[0]["step_2x2_distill"], inputs["jparams"],
                inputs["distill"], "distill", keep=keep_masks)


@pytest.mark.parametrize("case,mode", [("step_2x2_kp", "kp_position"),
                                       ("step_2x2_distill", "distill")])
def test_sharded_step_matches_jax(inputs, four, keep_masks, monkeypatch,
                                  case, mode):
    """The 2x2 sharded step against the JAX package's single-device step
    in float64, with JAX's keep-masks, as `test_torch_train_step.py`
    holds the port's single-device step."""
    import functools

    import jax
    import jax.numpy as jnp

    from accelerated_features_tpu.models import backbone as jb
    from accelerated_features_tpu.train import trainer as jt
    res = four[0][case]
    batch = inputs["distill" if mode == "distill" else "kp"]
    with jax.enable_x64(True):
        monkeypatch.setattr(jt, "xfeat_forward", functools.partial(
            jb.xfeat_forward, compute_dtype=jnp.float64))
        cfg = jt.TrainConfig(use_distill=mode == "distill",
                             use_kp_position=mode == "kp_position")
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              inputs["jparams"])
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        key = jax.random.key(1)
        (_, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jt.loss_fn(p, jbatch, key, cfg), has_aux=True))(params)
        new, met = jax.jit(lambda s: jt.train_step(s, jbatch, key, cfg))(
            jt.init_train_state(params, cfg))
    from accelerated_features_tpu_torch.models.params import params_to_jax
    for k in met:
        assert res["metrics"][k] == pytest.approx(float(met[k]), rel=1e-5,
                                                  abs=1e-7), k
    got = params_to_jax(_tree_t(res["state"]["params"]))
    _params_close(got, jax.tree.map(np.asarray, new["params"]),
                  jax.tree.map(np.asarray, grads), rel_stats=1e-4,
                  atol_stats=1e-5)


def test_trainer_cli_non_round_batch(four):
    """--batch_size 7: the 40/60 split gives 6 items, so on 4 ranks the
    data axis is 2 (the largest divisor of 6 and 4): ranks 0 and 1 train,
    2 and 3 sit out; the step must not fail on the shape."""
    losses = [f["cli_batch7"] for f in four]
    assert len(losses[0]) == 1 and np.isfinite(losses[0][0])
    assert losses[1] == losses[0] and losses[2] == losses[3] == []


@pytest.mark.parametrize("case", ["extract_2x1", "extract_4x1"])
def test_sharded_extraction_matches_single(inputs, two, four, case):
    from accelerated_features_tpu_torch.models.params import (fold_batchnorm,
                                                              params_from_jax)
    from accelerated_features_tpu_torch.ops.extraction import \
        detect_and_compute
    res = (two if case in two[0] else four)
    params = params_from_jax(fold_batchnorm(inputs["jparams"]))
    ref = detect_and_compute(params, torch.from_numpy(inputs["images"]),
                             top_k=64, detection_threshold=0.012)
    ref = {k: v.numpy() for k, v in ref.items()}
    for r in res[1:]:
        for k in ref:
            assert np.array_equal(r[case][k], res[0][case][k])
    got = res[0][case]
    assert got["keypoints"].shape == ref["keypoints"].shape
    # a rank runs its convolutions on fewer images and threads than one
    # call on the whole batch, which may round a score otherwise: a
    # keypoint tied with its neighbour within rounding may change
    for i in range(len(ref["keypoints"])):
        a = {tuple(p): j for j, p in enumerate(got["keypoints"][i].tolist())}
        b = {tuple(p): j for j, p in enumerate(ref["keypoints"][i].tolist())}
        shared = a.keys() & b.keys()
        assert len(shared) >= 0.95 * len(b), i
        ia = [a[p] for p in shared]
        ib = [b[p] for p in shared]
        np.testing.assert_allclose(got["scores"][i][ia], ref["scores"][i][ib],
                                   atol=1e-5)
        np.testing.assert_allclose(got["descriptors"][i][ia],
                                   ref["descriptors"][i][ib], atol=1e-5)


@pytest.mark.parametrize("case", ["mnn_1x2", "mnn_2x2", "mnn_1x4"])
def test_sp_matching_matches_single(inputs, two, four, case):
    from accelerated_features_tpu_torch.ops.matching import mnn_match
    res = (two if case in two[0] else four)
    t = {k: torch.from_numpy(v) for k, v in inputs["mnn"].items()}
    for gate, (idx, mask) in zip((0.1, -1.0), res[0][case]):
        ridx, rmask = mnn_match(t["d1"], t["d2"], t["v1"], t["v2"], gate)
        np.testing.assert_array_equal(mask, rmask.numpy())
        np.testing.assert_array_equal(idx[mask], ridx.numpy()[mask])
        assert mask.sum() > 10
    for r in res[1:]:
        for (a, b), (c, d) in zip(r[case], res[0][case]):
            assert np.array_equal(a, c) and np.array_equal(b, d)


def _tie_inputs():
    """Target descriptors duplicated across the two shards."""
    d1 = np.random.default_rng(7).normal(size=(16, 8)).astype(np.float32)
    return {"d1": d1, "d2": np.concatenate([d1[:8], d1[:8]]),
            "v1": np.ones(16, bool), "v2": np.ones(16, bool)}


def test_mnn_sp_first_index_ties(two):
    """Duplicated target descriptors: the first of the tied columns wins,
    across shards as within one, as in `mnn_match`."""
    from accelerated_features_tpu_torch.ops.matching import mnn_match
    t = {k: torch.from_numpy(v) for k, v in _tie_inputs().items()}
    ref = mnn_match(t["d1"], t["d2"], None, None, -1.0)
    idx, mask = two[0]["mnn_ties"][1]
    np.testing.assert_array_equal(mask, ref[1].numpy())
    np.testing.assert_array_equal(idx, ref[0].numpy())
    assert (idx[:8] == np.arange(8)).all()


@pytest.mark.parametrize("case", ["lg_1x2", "lg_1x4"])
def test_lighterglue_sp_matches_single_device(inputs, two, four, case):
    from accelerated_features_tpu_torch.models.lighterglue import \
        lighterglue_forward
    res = (two if case in two[0] else four)
    t = {k: torch.from_numpy(v) for k, v in inputs["lg"].items()}
    ref = lighterglue_forward(_tree_t(inputs["lg_w"]), **t)
    rm, rs = ref["matches0"].numpy(), ref["mscores0"].numpy()
    v = inputs["lg"]["mask0"]
    gm, gs = res[0][case]
    np.testing.assert_array_equal(gm[v], rm[v])
    np.testing.assert_allclose(gs[v], rs[v], atol=1e-4)
    assert (gm[~v] == -1).all() and (gs[~v] == 0).all()
    assert (gm >= 0).sum() > 10


@pytest.mark.parametrize("case", ["ba_2x1", "ba_point_2x1", "ba_point_4x1"])
def test_sharded_ba_matches_single_device(inputs, two, four, case):
    from accelerated_features_tpu_torch.sfm.ba import bundle_adjust
    res = (two if case in two[0] else four)
    single, st = bundle_adjust(_port_problem(inputs["ba"]), iters=5,
                               cg_iters=20)
    cams, points, stats = res[0][case]
    assert stats["final_cost"] == pytest.approx(float(st["final_cost"]),
                                                rel=1e-5)
    np.testing.assert_allclose(cams, single.cams.numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(points, single.points.numpy(), atol=2e-3,
                               rtol=1e-3)


def test_point_partition_memory_layout():
    """The partition divides the map: each rank's point shard is P/n and
    every observation lands on its point's owner, as JAX's partition."""
    import jax.numpy as jnp

    from accelerated_features_tpu.parallel.ba import \
        partition_by_point as jpartition
    from accelerated_features_tpu.sfm.ba import BAProblem as JProblem
    from accelerated_features_tpu_torch.parallel.ba import partition_by_point

    a = _ba_problem(seed=1, Pn=203, N=900)
    prob = _port_problem(a)
    ndev = 8
    q, inverse = partition_by_point(prob, ndev)
    ppad = q.points.shape[0]
    assert ppad % ndev == 0
    ploc = ppad // ndev
    np.testing.assert_array_equal(q.points[inverse][:203].numpy(),
                                  a["points"])
    nloc = q.obs_pt.shape[0] // ndev
    op = q.obs_pt.numpy().reshape(ndev, nloc)
    om = q.obs_mask.numpy().reshape(ndev, nloc)
    assert (op[om] < ploc).all()
    assert om.sum() == int(a["obs_mask"].sum())
    jq, jinv = jpartition(JProblem(**{
        k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
        for k, v in a.items()}), ndev)
    for name in ("points", "obs_cam", "obs_pt", "obs_uv", "obs_mask"):
        np.testing.assert_array_equal(getattr(q, name).numpy(),
                                      np.asarray(getattr(jq, name)))
    np.testing.assert_array_equal(inverse.numpy(), np.asarray(jinv))


def test_pad_observations_equals_jax():
    import jax.numpy as jnp

    from accelerated_features_tpu.parallel.ba import \
        pad_observations as jpad
    from accelerated_features_tpu.sfm.ba import BAProblem as JProblem
    from accelerated_features_tpu_torch.parallel.ba import pad_observations
    a = _ba_problem(N=1001)
    got = pad_observations(_port_problem(a), 8)
    ref = jpad(JProblem(**{k: jnp.asarray(v) for k, v in a.items()}), 8)
    assert got.obs_cam.shape[0] == 1008
    for name in ("obs_cam", "obs_pt", "obs_uv", "obs_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_ba_collective_accounting_matches_the_run():
    """`collective_accounting` against the camera-space sums one LM
    iteration of `bundle_adjust` really all-reduces (counted through its
    `reduce_cam` hook, point sums local): only C*36, C*6 and scalar
    payloads, in the inventory U and S_diag (C*36 x2), b_c, rhs and every
    CG matvec (C*6 x (2 + cg_iters)), two cost scalars; then the
    accounting and weak-scaling numbers equal the JAX package's."""
    from accelerated_features_tpu.parallel import ba as jba
    from accelerated_features_tpu_torch.parallel import ba as pba
    from accelerated_features_tpu_torch.sfm.ba import bundle_adjust

    C, cg = 8, 5
    sizes = []

    def count(t):
        sizes.append(t.numel())
        return t
    prob = _port_problem(_ba_problem(C=C, Pn=64, N=256))
    bundle_adjust(prob, iters=1, cg_iters=cg, reduce_cam=count)
    per_iter = sizes[1:]                    # after the initial cost
    assert set(per_iter) <= {C * 36, C * 6, 1}, sorted(set(per_iter))
    assert per_iter.count(C * 36) == 2
    assert per_iter.count(C * 6) == 2 + cg
    assert per_iter.count(1) == 2
    acct = pba.collective_accounting(C, cg_iters=cg)
    assert acct["per_lm_iteration"] == 4 * sum(per_iter)
    for precond in (True, False):
        assert pba.collective_accounting(C, cg, precond=precond) == \
            jba.collective_accounting(C, cg, precond=precond)
    assert pba.flops_accounting(1000, C, 64, cg) == \
        jba.flops_accounting(1000, C, 64, cg)
    assert pba.hbm_accounting(1000, 64, cg) == \
        jba.hbm_accounting(1000, 64, cg)
    r = pba.predicted_weak_scaling(n_cams=C, n_pts_per_dev=64,
                                   obs_per_pt=4.0, ndev=8, cg_iters=cg)
    assert r == jba.predicted_weak_scaling(n_cams=C, n_pts_per_dev=64,
                                           obs_per_pt=4.0, ndev=8,
                                           cg_iters=cg)
    assert r["n_collectives_per_iter"] == 5 + 5 + 1


def test_ba_weak_scaling_prediction():
    """The JAX package's model (its TPU-slice defaults) through the port's
    functions: the same efficiencies, falling with the device count."""
    from accelerated_features_tpu.parallel import ba as jba
    from accelerated_features_tpu_torch.parallel import ba as pba
    effs = []
    for ndev in (2, 4, 8, 16):
        kw = dict(n_cams=1000, n_pts_per_dev=1_000_000 // 8, obs_per_pt=4.0,
                  ndev=ndev)
        r = pba.predicted_weak_scaling(**kw)
        assert r == jba.predicted_weak_scaling(**kw)
        effs.append(r["efficiency"])
    assert all(e1 >= e2 - 1e-9 for e1, e2 in zip(effs, effs[1:]))
    assert effs[0] >= 0.95 and effs[2] >= 0.8


def test_param_pspecs_mirror_jax():
    """The port's specs are JAX's on the port's (out, in) weights."""
    import jax

    from accelerated_features_tpu.models.params import init_xfeat_params
    from accelerated_features_tpu.train import trainer as jt
    from accelerated_features_tpu_torch.models.params import params_from_jax
    from accelerated_features_tpu_torch.train import trainer as tt
    jp = init_xfeat_params(jax.random.key(0))
    js = jt.param_pspecs(jp)
    ts = tt.param_pspecs(params_from_jax(jax.tree.map(np.asarray, jp)))
    for name in js:
        if name == "fine_matcher":
            continue
        for a, b in zip(jax.tree.leaves(js[name], is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)), jax.tree.leaves(ts[name])):
            assert tuple(a) == () and b == ()
    for jl, tl in zip(js["fine_matcher"], ts["fine_matcher"]):
        for k in jl:
            j = tuple(jl[k])
            want = j[::-1] if k == "w" else j   # JAX w is (in, out)
            assert tl[k] == want, (k, j, tl[k])
    assert tt.batch_pspecs({"image0": 0}) == {"image0": ("data",)}


def test_distributed_helpers_without_a_group(monkeypatch):
    from accelerated_features_tpu_torch.parallel import distributed
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_primary()
    mesh = distributed.make_pod_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        distributed.make_pod_mesh(model=2)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, device="cpu")


def test_a_failing_rank_fails_the_group():
    with pytest.raises(RuntimeError, match="boom on rank 1"):
        run_ranks(_fail_on_one, 2, device="cpu", timeout=TIMEOUT)


def _fail_on_one(rank):
    if rank == 1:
        raise ValueError("boom on rank 1")
    return rank


@pytest.mark.parametrize("entry", ["run_ranks", "dryrun_multigpu"])
def test_spawned_ranks_default_to_the_card(entry, monkeypatch):
    """Without `device`, the ranks go on the cards: with none, the call
    raises before it spawns anything, and names `device='cpu'`."""
    from accelerated_features_tpu_torch.parallel import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"run_ranks": lambda: dryrun.run_ranks(_fail_on_one, 2),
            "dryrun_multigpu": lambda: dryrun.dryrun_multigpu(2)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_writer_is_none_without_tensorboard(tmp_path, monkeypatch):
    """As in the JAX package: no `tensorboard`, no writer (the card
    machine has none)."""
    from accelerated_features_tpu_torch.train import run
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert run._make_writer(str(tmp_path)) is None
