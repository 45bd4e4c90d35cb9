"""The frozen reference (`xfeat_bench/reference`) agrees with the port's
CPU path on a few holdout views at a small size: extraction, MNN, and
LighterGlue with pruning engaged. The only test that imports both."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.models import lighterglue as port_lg
from accelerated_features_tpu_torch.models import params as port_params
from accelerated_features_tpu_torch.ops import extraction as port_ex
from accelerated_features_tpu_torch.ops import matching as port_mnn
from xfeat_bench import check, inputs
from xfeat_bench.reference import lighterglue as ref_lg
from xfeat_bench.reference import mnn as ref_mnn
from xfeat_bench.reference import weights

ROOT = Path(__file__).resolve().parents[2]
XFEAT = str(ROOT / "artifacts" / "run_md_ckpt13250.npz")
LG = str(ROOT / "artifacts" / "lighterglue_ft_ckpt7791.npz")
CONF = {"input_dim": 64, "descriptor_dim": 96, "n_layers": 6,
        "num_heads": 1, "width_confidence": 0.95, "pruning_min_kpts": 0}


@pytest.fixture(scope="module")
def views():
    torch.set_num_threads(2)
    v = inputs.Views(ROOT / "artifacts" / "rendered_pose_holdout",
                     "rendered_pose_pairs.json", crop_hw=(200, 260))
    return v.images[[0, 7, 20, 41]]


@pytest.fixture(scope="module")
def port_features(views):
    params = port_params.load_params(XFEAT)
    with torch.inference_mode():
        out = port_ex.detect_and_compute(params, torch.from_numpy(views),
                                         64, 0.05)
    return {k: v.numpy() for k, v in out.items()}


def test_extraction_agrees(views, port_features):
    # 200x260 -> 192x256 inside both: the resize and its coordinate scale
    assert port_features["valid"].sum() > 200
    gaps = check.judge_extraction(weights.load_xfeat(XFEAT, "cpu"), views,
                                  port_features, 64, 0.05, "cpu")
    assert gaps["select_gap"] <= 1e-6, gaps
    assert gaps["score_gap"] <= 1e-5 and gaps["desc_gap"] <= 1e-5, gaps


def test_mnn_agrees(port_features):
    d = torch.from_numpy(port_features["descriptors"])
    v = torch.from_numpy(port_features["valid"])
    v[1, 50:] = False
    a, b = torch.tensor([0, 1, 2]), torch.tensor([1, 2, 3])
    idx, mask = port_mnn.batch_mnn_match(d[a], d[b], v[a], v[b], -1.0)
    ridx, rmask = ref_mnn.match(d[a], d[b], v[a], v[b], -1.0)
    assert torch.equal(mask, rmask)
    assert torch.equal(idx[mask], ridx[rmask])
    gap = check.judge_mnn(d, v, [(0, 1), (1, 2), (2, 3)], idx.numpy(),
                          mask.numpy())
    assert gap["mnn_gap"] == 0.0


def _biased(tree, bias):
    """Matchability heads pushed down so that width pruning removes
    points at these small sizes (the trained heads keep them all)."""
    out = copy.deepcopy(tree)
    for asg in out["assignments"][:-1]:
        asg["matchability"]["b"] = asg["matchability"]["b"] - bias
    return out


def test_lighterglue_with_pruning_agrees(port_features):
    bias = 3.0
    port = _biased(port_params.load_lighterglue_params(LG), bias)
    ref = _biased(weights.load_lighterglue(LG, "cpu"), bias)
    f = {k: torch.from_numpy(v) for k, v in port_features.items()}
    size = torch.tensor([[256.0, 200.0]] * 2)
    with torch.inference_mode():
        out = port_lg.lighterglue_forward(
            port, f["keypoints"][:2], f["keypoints"][2:],
            f["descriptors"][:2], f["descriptors"][2:], size, size,
            f["valid"][:2], f["valid"][2:], width_confidence=0.95,
            pruning_min_kpts=0)
    kept = int(out["keep0"].sum() + out["keep1"].sum())
    assert 0 < kept < int(f["valid"].sum()), "pruning did not engage"
    for i in range(2):
        def side(j):
            return {k: f[k][j] for k in ("keypoints", "descriptors",
                                         "valid")}
        r = check.judge_lighterglue_pair(
            ref, CONF, side(i), side(2 + i), size[i],
            {k: out[k][i] for k in ("matches0", "mscores0", "keep0",
                                    "keep1")})
        assert r["matcher_gap"] <= 1e-4 and r["mscore_gap"] <= 1e-5, r
        assert any(not bool(d[3].all()) for d in r["decisions"][0]
                   + r["decisions"][1])
        own = ref_lg.forward_pair(
            ref, CONF, f["keypoints"][i][f["valid"][i]],
            f["keypoints"][2 + i][f["valid"][2 + i]],
            f["descriptors"][i][f["valid"][i]],
            f["descriptors"][2 + i][f["valid"][2 + i]], size[i], size[i])
        assert np.array_equal(own["matches0"].numpy(),
                              _valid_matches(out, f, i))


def _valid_matches(out, f, i):
    """The port's matches0 of image i's valid slots, as indices among
    image 1's valid slots (-1 unmatched)."""
    v0 = torch.nonzero(f["valid"][i])[:, 0]
    v1 = torch.nonzero(f["valid"][2 + i])[:, 0]
    where = {int(s): j for j, s in enumerate(v1)}
    return np.array([where.get(int(m), -2) if m >= 0 else -1
                     for m in out["matches0"][i][v0]])
