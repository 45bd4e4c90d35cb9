"""The port's weight loading against the JAX package's: the same `.npz`
and the same random init must give equal leaves (torch layouts mapped
back to JAX's)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from accelerated_features_tpu.api import load_params as jax_load_params
from accelerated_features_tpu.models.params import (count_params,
                                                    fold_batchnorm,
                                                    init_xfeat_params)
from accelerated_features_tpu_torch import params_from_jax
from accelerated_features_tpu_torch.models.params import (
    count_params as port_count_params, fold_batchnorm as port_fold_batchnorm,
    init_xfeat_params as port_init_xfeat_params, load_npz_tree, load_params)

CKPT = str(Path(__file__).resolve().parents[1] / "artifacts"
           / "run_md_ckpt13250.npz")


def _pairs(jax_tree, port_tree, path=""):
    """Yield (path, key, jax leaf, port leaf) over both trees."""
    if isinstance(jax_tree, dict):
        assert set(jax_tree) == set(port_tree), path
        for k in jax_tree:
            if isinstance(jax_tree[k], (dict, list)):
                yield from _pairs(jax_tree[k], port_tree[k], f"{path}/{k}")
            else:
                yield f"{path}/{k}", k, jax_tree[k], port_tree[k]
    else:
        assert len(jax_tree) == len(port_tree), path
        for i, (a, b) in enumerate(zip(jax_tree, port_tree)):
            yield from _pairs(a, b, f"{path}/{i}")


def _to_jax_layout(key, t):
    a = t.numpy()
    if key == "w" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if key == "w" and a.ndim == 2:
        return a.T
    return a


def _assert_equal_trees(jax_tree, port_tree):
    n = 0
    for path, key, a, b in _pairs(jax_tree, port_tree):
        np.testing.assert_array_equal(_to_jax_layout(key, b), np.asarray(a),
                                      err_msg=path)
        n += 1
    assert n > 50


@pytest.mark.parametrize("folded", [False, True])
def test_params_from_jax_init(folded):
    tree = init_xfeat_params(jax.random.key(0))
    if folded:
        tree = fold_batchnorm(tree)
    np_tree = jax.tree.map(np.asarray, tree)
    _assert_equal_trees(tree, params_from_jax(np_tree))


@pytest.mark.parametrize("fold_bn", [False, True])
def test_npz_loader_matches_load_params(fold_bn):
    _assert_equal_trees(jax_load_params(CKPT, fold_bn=fold_bn),
                        load_params(CKPT, fold_bn=fold_bn))


def test_fold_batchnorm_is_bit_identical():
    tree = load_npz_tree(CKPT)
    ref = fold_batchnorm(jax.tree.map(np.asarray, tree))
    got = port_fold_batchnorm(tree)
    for path, _, a, b in _pairs(ref, got):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=path)


def test_params_are_float32_torch_layout():
    p = load_params(CKPT)
    assert tuple(p["block1"][0]["w"].shape) == (4, 1, 3, 3)
    assert tuple(p["keypoint_head"][-1]["w"].shape) == (65, 64, 1, 1)
    assert tuple(p["fine_matcher"][0]["w"].shape) == (512, 128)
    assert all("mean" not in layer for layer in p["block3"])


def test_init_tree_has_the_jax_structure_shapes_and_bounds():
    """The port's random init (drawn by torch) against the JAX init: the
    same tree, the same shapes, the same parameter count, and every value
    inside the bound JAX draws it from (running stats exactly 0 and 1)."""
    ref = init_xfeat_params(jax.random.key(0))
    got = port_init_xfeat_params()
    assert port_count_params(got) == count_params(ref) \
        == port_count_params(ref)
    fan_in = {}  # a layer's weight and bias share the weight's fan-in
    for path, key, a, b in _pairs(ref, got):
        if key == "w":
            fan_in[path[:-2]] = int(np.prod(np.shape(a)[:-1]))
    for path, key, a, b in _pairs(ref, got):
        a = np.asarray(a)
        assert b.shape == a.shape and b.dtype == np.float32, path
        if key in ("mean", "var"):
            assert np.array_equal(b, a), path
            continue
        bound = 1.0 / np.sqrt(fan_in[path[:-2]])
        assert np.abs(a).max() <= bound, path
        assert np.abs(b).max() <= bound, path
        if b.size >= 64:  # spread over the interval, as JAX's draw
            assert np.abs(b).max() > 0.9 * bound, path
    again = port_init_xfeat_params(torch.Generator().manual_seed(0))
    other = port_init_xfeat_params(torch.Generator().manual_seed(1))
    leaves = [(b, c, d) for (_, _, b, c), (_, _, _, d) in
              zip(_pairs(got, again), _pairs(got, other))]
    assert all(np.array_equal(b, c) for b, c, _ in leaves)
    assert not all(np.array_equal(b, d) for b, _, d in leaves)


def test_random_extractor_runs_on_the_cpu():
    """`XFeat(weights=None)` is a random, BatchNorm-folded extractor, as in
    the JAX package; it extracts from a seeded texture at the untrained
    threshold 0.012."""
    from accelerated_features_tpu_torch import XFeat
    xf = XFeat(weights=None, top_k=256, detection_threshold=0.012,
               device="cpu")
    assert torch.equal(xf.model.params["block1"][0]["w"],
                       load_params(None)["block1"][0]["w"])
    rng = np.random.default_rng(0)
    img = np.kron(rng.uniform(0, 255, (24, 32)), np.ones((4, 4)))
    out = xf.detectAndCompute(img.astype(np.uint8))[0]
    n = len(out["keypoints"])
    assert 0 < n <= 256 and out["descriptors"].shape == (n, 64)
    assert bool(torch.isfinite(out["descriptors"]).all())
    assert torch.allclose(out["descriptors"].norm(dim=1), torch.ones(n),
                          atol=1e-5)
