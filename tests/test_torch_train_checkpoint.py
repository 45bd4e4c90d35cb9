"""Train-state checkpoints shared by the two packages: the port writes and
reads the JAX package's `.npz` layout (`utils/checkpoint.py`), its
`params_to_jax` inverts `params_from_jax`, the committed train states
resume in the port, and the JAX package reads what the port wrote. Values
are compared exactly: the layouts are transposes of each other."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.models.params import \
    init_xfeat_params as jax_init
from accelerated_features_tpu.train import trainer as jt
from accelerated_features_tpu.utils import checkpoint as jck
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.models.lighterglue import (
    DEFAULT_CONF, init_lighterglue_params)
from accelerated_features_tpu_torch.models.params import (
    init_xfeat_params, load_npz_tree, params_from_jax, params_to_jax)
from accelerated_features_tpu_torch.train import optim
from accelerated_features_tpu_torch.train import trainer as tt
from accelerated_features_tpu_torch.train.lighterglue_run import \
    init_lg_train_state
from accelerated_features_tpu_torch.utils import checkpoint as tck

from torch_support import ARTIFACTS, LG_CKPT, leaves

CFG = dict(use_distill=False, use_kp_position=True)


def _equal_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_params_to_jax_inverts_params_from_jax():
    tree = init_xfeat_params(torch.Generator().manual_seed(1))
    back = params_to_jax(params_from_jax(tree))
    _equal_trees(back, tree)
    assert leaves(back)["block1/0/w"].shape == (3, 3, 1, 4)
    lg = jax.tree.map(np.asarray, jlg.init_lighterglue_params(
        jax.random.key(0), jlg.DEFAULT_CONF))
    from accelerated_features_tpu_torch.models.params import \
        load_lighterglue_params
    _equal_trees(params_to_jax(load_lighterglue_params(lg)), lg)


def test_committed_train_state_resumes_at_step_3000():
    """artifacts/run_tf_ckpt3000.npz (the JAX trainer's state) restores
    into the port's train state at step 3000 with its Adam moments, and
    `XFeat(weights=that file)` detects keypoints."""
    path = str(ARTIFACTS / "run_tf_ckpt3000.npz")
    target = tt.init_train_state(params_from_jax(init_xfeat_params()),
                                 tt.TrainConfig(**CFG))
    state = tck.restore_checkpoint(path, target)
    assert int(state["step"]) == 3000
    assert int(state["opt_state"][1].count) == 3000
    assert int(state["opt_state"][2].count) == 3000
    flat = np.load(path)
    np.testing.assert_array_equal(
        params_to_jax(state["opt_state"][1].mu)["block3"][1]["w"],
        flat["opt_state/1/1/block3/1/w"])
    np.testing.assert_array_equal(
        params_to_jax(state["params"])["fine_matcher"][0]["w"],
        flat["params/fine_matcher/0/w"])
    xf = XFeat(weights=path, top_k=32, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    assert len(xf.detectAndCompute(x)[0]["keypoints"]) > 0


def test_jax_reads_a_port_checkpoint(tmp_path):
    """A state the port wrote restores into the JAX package's train state
    (params, Adam moments and counts equal) and through its
    `load_params_from_checkpoint`; the port reads it back and loads the
    directory's newest checkpoint into XFeat."""
    cfg = tt.TrainConfig(**CFG)
    state = tt.init_train_state(
        params_from_jax(init_xfeat_params(torch.Generator().manual_seed(2))),
        cfg)
    state["opt_state"] = (state["opt_state"][0], optim.ScaleByAdamState(
        torch.tensor(7, dtype=torch.int32),
        optim.tree_map(lambda t: t + 0.5, state["params"]),
        optim.tree_map(lambda t: t * t, state["params"])),
        optim.ScaleByScheduleState(torch.tensor(7, dtype=torch.int32)))
    state["step"] = torch.tensor(7, dtype=torch.int32)
    ck = tmp_path / "ck"
    tck.save_checkpoint(str(ck), state, 3)
    path = tck.save_checkpoint(str(ck), state, 7)
    assert tck.latest_checkpoint(str(ck)) == path

    jtarget = jax.device_get(jt.init_train_state(jax_init(jax.random.key(0)),
                                                 jt.TrainConfig(**CFG)))
    jstate = jck.restore_checkpoint(path, jtarget)
    assert int(jstate["step"]) == 7 and int(jstate["opt_state"][1].count) == 7
    _equal_trees(jstate["params"], params_to_jax(state["params"]))
    _equal_trees(jstate["opt_state"][1].mu,
                 params_to_jax(state["opt_state"][1].mu))
    _equal_trees(jstate["opt_state"][1].nu,
                 params_to_jax(state["opt_state"][1].nu))
    _equal_trees(jck.load_params_from_checkpoint(str(ck)),
                 params_to_jax(state["params"]))

    back = tck.restore_checkpoint(path, tt.init_train_state(
        params_from_jax(init_xfeat_params()), cfg))
    _equal_trees(params_to_jax(back["params"]),
                 params_to_jax(state["params"]))
    _equal_trees(params_to_jax(tck.load_params_from_checkpoint(str(ck))),
                 params_to_jax(state["params"]))
    xf = XFeat(weights=str(ck), top_k=16, device="cpu")
    assert xf.model.params["block1"][0]["w"].shape == (4, 1, 3, 3)


def test_port_reads_jax_checkpoints(tmp_path):
    """A JAX-written XFeat train state (its `_flatten` layout, as its npz
    writer saves it) and the committed LighterGlue state (field-name keys
    and a pickled placeholder of optax's empty state) restore into the
    port's states."""
    jstate = jax.device_get(jt.init_train_state(jax_init(jax.random.key(4)),
                                                jt.TrainConfig(**CFG)))
    path = str(tmp_path / "ckpt_00000000.npz")
    np.savez(path, **jck._flatten(jstate))
    state = tck.restore_checkpoint(path, tt.init_train_state(
        params_from_jax(init_xfeat_params()), tt.TrainConfig(**CFG)))
    _equal_trees(params_to_jax(state["params"]), jstate["params"])

    lg_path = LG_CKPT
    params = init_lighterglue_params(torch.Generator().manual_seed(0),
                                     DEFAULT_CONF)
    lg = tck.restore_checkpoint(lg_path, init_lg_train_state(
        params, optim.adam(1e-4)))
    assert int(lg["step"]) == 7791 and int(lg["opt_state"][0].count) == 7791
    tree = load_npz_tree(lg_path)
    _equal_trees(params_to_jax(lg["params"]), tree)
    with np.load(lg_path, allow_pickle=True) as f:
        np.testing.assert_array_equal(
            params_to_jax(lg["opt_state"][0].nu)["layers"][2]["cross"]
            ["to_qk"]["w"], f["opt_state/0/nu/layers/2/cross/to_qk/w"])


def test_port_reads_jax_orbax_checkpoints(tmp_path, monkeypatch):
    """The JAX package's own `save_checkpoint` writes an orbax directory
    `ckpt_<step>/`; the port lists it, restores it (step and every leaf
    equal) through `restore_checkpoint` and `resume_or_init`, and loads
    its parameters through `XFeat(weights=dir)` and
    `LighterGlue(weights=dir)`. Without tensorstore it raises, naming
    the directory, and never starts afresh."""
    from accelerated_features_tpu.train import lighterglue_run as jlr
    import optax
    from accelerated_features_tpu_torch import LighterGlue

    jstate = jt.init_train_state(jax_init(jax.random.key(5)),
                                 jt.TrainConfig(**CFG))
    jstate = dict(jstate, step=jax.numpy.asarray(9, jax.numpy.int32))
    ck = tmp_path / "ck"
    path = jck.save_checkpoint(str(ck), jstate, 9)
    assert Path(path).is_dir() and Path(path).name == "ckpt_00000009"
    assert tck.latest_checkpoint(str(ck)) == path
    jstate = jax.device_get(jstate)

    target = tt.init_train_state(params_from_jax(init_xfeat_params()),
                                 tt.TrainConfig(**CFG))
    state = tck.restore_checkpoint(path, target)
    resumed, ok = tck.resume_or_init(str(ck), target)
    assert ok and int(state["step"]) == int(resumed["step"]) == 9
    for got in (state, resumed):
        _equal_trees(params_to_jax(got["params"]), jstate["params"])
        for i in (1, 2):
            assert int(got["opt_state"][i].count) == \
                int(jstate["opt_state"][i].count)
        _equal_trees(params_to_jax(got["opt_state"][1].mu),
                     jstate["opt_state"][1].mu)
        _equal_trees(params_to_jax(got["opt_state"][1].nu),
                     jstate["opt_state"][1].nu)
    _equal_trees(params_to_jax(tck.load_params_from_checkpoint(path)),
                 jstate["params"])
    xf = XFeat(weights=str(ck), top_k=16, device="cpu")
    ref = XFeat(weights=jstate["params"], top_k=16, device="cpu")
    for a, b in zip(leaves(xf.model.params).values(),
                    leaves(ref.model.params).values()):
        np.testing.assert_array_equal(a, b)

    lg_params = jlg.init_lighterglue_params(jax.random.key(6),
                                            jlg.DEFAULT_CONF)
    lg_state = jlr.init_lg_train_state(lg_params, optax.adam(1e-4))
    lg_dir = tmp_path / "lg"
    jck.save_checkpoint(str(lg_dir), lg_state, 3)
    lg = LighterGlue(weights=str(lg_dir), device="cpu")
    _equal_trees(params_to_jax(lg.params), jax.device_get(lg_params))
    port_lg = tck.restore_checkpoint(
        tck.latest_checkpoint(str(lg_dir)),
        init_lg_train_state(init_lighterglue_params(
            torch.Generator().manual_seed(0), DEFAULT_CONF),
            optim.adam(1e-4)))
    assert int(port_lg["step"]) == 0
    _equal_trees(params_to_jax(port_lg["params"]), jax.device_get(lg_params))

    monkeypatch.setitem(__import__("sys").modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="ckpt_00000009.*tensorstore"):
        tck.resume_or_init(str(ck), target)


def test_checkpoint_key_mismatch_raises(tmp_path):
    state = tt.init_train_state(params_from_jax(init_xfeat_params()),
                                tt.TrainConfig(**CFG))
    path = tck.save_checkpoint(str(tmp_path), state, 1)
    params = init_lighterglue_params(torch.Generator().manual_seed(0),
                                     DEFAULT_CONF)
    with pytest.raises(KeyError, match="mismatch"):
        tck.restore_checkpoint(path, init_lg_train_state(params,
                                                         optim.adam(1e-4)))
