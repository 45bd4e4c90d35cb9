"""The port's `config.py` against the JAX package's: the same frozen tree
with the same field values, and `make_xfeat` passing its fields through;
and the port's hub entries (`hub.py`)."""

import dataclasses

import pytest
import torch

from accelerated_features_tpu import config as jax_config
from accelerated_features_tpu_torch import config
from accelerated_features_tpu_torch.models.lighterglue import DEFAULT_CONF


def test_default_tree_equals_the_jax_packages():
    assert dataclasses.asdict(config.DEFAULT) == \
        dataclasses.asdict(jax_config.DEFAULT)
    assert [f.name for f in dataclasses.fields(config.Config)] == \
        [f.name for f in dataclasses.fields(jax_config.Config)]


def test_config_is_frozen_and_replaceable():
    with pytest.raises(dataclasses.FrozenInstanceError):
        config.DEFAULT.detector.top_k = 1
    c = config.DEFAULT.replace(
        detector=config.DetectorConfig(top_k=128))
    assert c.detector.top_k == 128 and config.DEFAULT.detector.top_k == 4096


def test_make_xfeat_passes_its_fields_through():
    cfg = config.Config(
        detector=config.DetectorConfig(top_k=321, detection_threshold=0.02,
                                       compute_dtype="bfloat16"),
        matching=config.MatchingConfig(fused_kernel=False))
    xf = config.make_xfeat(cfg, device="cpu")
    assert (xf.top_k, xf.detection_threshold) == (321, 0.02)
    assert xf.compute_dtype == torch.bfloat16
    assert xf.fused_matching is False and xf.device.type == "cpu"
    # fused_kernel None: the plain matcher on the CPU
    assert config.make_xfeat(device="cpu").fused_matching is False


def test_make_xfeat_weights_none_is_random_and_defaults_to_the_card(
        monkeypatch):
    from accelerated_features_tpu_torch.models.params import (
        init_xfeat_params, load_params)
    xf = config.make_xfeat(device="cpu")
    ref = load_params(init_xfeat_params())
    assert torch.equal(xf.model.params["skip1"]["w"], ref["skip1"]["w"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.make_xfeat()


def test_hub_entries(monkeypatch):
    """`hub.py`, the port's counterpart of the root `hubconf.py`: None is
    random (as in the JAX entries), keywords pass through, and without a
    device and a GPU the entries raise."""
    from accelerated_features_tpu_torch import hub
    from accelerated_features_tpu_torch.models.params import load_params
    assert hub.dependencies == ["torch", "numpy"]
    xf = hub.XFeat(top_k=77, detection_threshold=0.02, device="cpu",
                   compute_dtype="bfloat16")
    assert (xf.top_k, xf.detection_threshold) == (77, 0.02)
    assert xf.compute_dtype == torch.bfloat16
    assert torch.equal(xf.model.params["block1"][0]["w"],
                       load_params(None)["block1"][0]["w"])
    lg = hub.LighterGlue(device="cpu", conf={**DEFAULT_CONF, "n_layers": 2})
    assert len(lg.params["layers"]) == 2 and lg.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (hub.XFeat, hub.LighterGlue):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()

