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

ART = Path(__file__).resolve().parents[1] / "artifacts"
CFG = dict(use_distill=False, use_kp_position=True)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_params_to_jax_inverts_params_from_jax():
    tree = init_xfeat_params(torch.Generator().manual_seed(1))
    back = params_to_jax(params_from_jax(tree))
    _equal_trees(back, tree)
    assert _leaves(back)["block1/0/w"].shape == (3, 3, 1, 4)
    lg = jax.tree.map(np.asarray, jlg.init_lighterglue_params(
        jax.random.key(0), jlg.DEFAULT_CONF))
    from accelerated_features_tpu_torch.models.params import \
        load_lighterglue_params
    _equal_trees(params_to_jax(load_lighterglue_params(lg)), lg)


def test_committed_train_state_resumes_at_step_3000():
    """artifacts/run_tf_ckpt3000.npz (the JAX trainer's state) restores
    into the port's train state at step 3000 with its Adam moments, and
    `XFeat(weights=that file)` detects keypoints."""
    path = str(ART / "run_tf_ckpt3000.npz")
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

    lg_path = str(ART / "lighterglue_ft_ckpt7791.npz")
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


def test_checkpoint_key_mismatch_raises(tmp_path):
    state = tt.init_train_state(params_from_jax(init_xfeat_params()),
                                tt.TrainConfig(**CFG))
    path = tck.save_checkpoint(str(tmp_path), state, 1)
    params = init_lighterglue_params(torch.Generator().manual_seed(0),
                                     DEFAULT_CONF)
    with pytest.raises(KeyError, match="mismatch"):
        tck.restore_checkpoint(path, init_lg_train_state(params,
                                                         optim.adam(1e-4)))
