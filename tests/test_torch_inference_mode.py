"""The bundle adjustment, the pose graph and the batched RANSAC inside
`torch.inference_mode()` against the same calls outside it, on the CPU.

Their `torch.func` forward-mode Jacobians go through
`sfm/lie.outside_inference_mode`: some torch builds (the CUDA build of the
card's machine) refuse `jacfwd` on inference tensors, so inside inference
mode the Jacobians are taken with it off, on ordinary clones. The results
must be equal bit for bit either way. This CPU build accepts the original
calls too, so here the tests hold the equality and the helper's contract;
`chip_smoke.py` holds the same equalities on the card, where the old code
fails."""

import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.apps.bench_suite import _synth_ba
from accelerated_features_tpu_torch.geometry import ransac as tr
from accelerated_features_tpu_torch.parallel.ba import bundle_adjust_sharded
from accelerated_features_tpu_torch.parallel.mesh import local_mesh
from accelerated_features_tpu_torch.sfm import ba
from accelerated_features_tpu_torch.sfm.lie import outside_inference_mode
from accelerated_features_tpu_torch.sfm.posegraph import (PoseGraph,
                                                          optimize_pose_graph)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_helper_runs_as_is_outside_and_on_clones_inside():
    seen = []

    def fn(*args):
        seen.append([(a, a.is_inference(), torch.is_inference_mode_enabled())
                     for a in args])
        return args[0] * 2

    x = torch.ones(3)
    assert torch.equal(outside_inference_mode(fn, x), 2 * x)
    assert seen[-1] == [(x, False, False)]
    with torch.inference_mode():
        y = torch.ones(3)
        out = outside_inference_mode(fn, y, x)
        assert not out.is_inference()
    (a, a_inf, mode), (b, b_inf, _) = seen[-1]
    assert a is not y and torch.equal(a, y) and not a_inf and not mode
    assert b is x and not b_inf
    # an inference tensor given outside inference mode is cloned too
    outside_inference_mode(fn, y)
    assert seen[-1][0][0] is not y and not seen[-1][0][1]


@pytest.mark.parametrize("size", [(6, 40, 3), (8, 200, 4)])
def test_bundle_adjust_inside_inference_mode(size):
    out, info = ba.bundle_adjust(_synth_ba(*size), iters=6)
    with torch.inference_mode():
        got, ginfo = ba.bundle_adjust(_synth_ba(*size), iters=6)
    _same(got, out)
    _same(list(ginfo.values()), list(info.values()))


def test_sharded_bundle_adjust_inside_inference_mode():
    mesh = local_mesh()
    out, info = bundle_adjust_sharded(_synth_ba(6, 40, 3), mesh, iters=4)
    with torch.inference_mode():
        got, ginfo = bundle_adjust_sharded(_synth_ba(6, 40, 3), mesh,
                                           iters=4)
    _same(got, out)
    _same(list(ginfo.values()), list(info.values()))


def test_pose_graph_inside_inference_mode():
    rng = np.random.default_rng(0)
    g = PoseGraph.empty()
    for i in range(6):
        g.add_keyframe(np.r_[0.01 * i, 0, 0, i, 0, 0] + rng.normal(0, 0.01, 6))
    for i in range(5):
        g.add_edge(i, i + 1, np.r_[0.01, 0, 0, 1, 0, 0])
    g.add_edge(0, 5, np.r_[0.3, 0, 0, 5, 0, 0])    # a false loop edge
    ref = optimize_pose_graph(g, device="cpu")
    with torch.inference_mode():
        got = optimize_pose_graph(g, device="cpu")
    assert np.array_equal(got[0], ref[0]) and got[1] == ref[1]
    assert ref[1]["final_cost"] < ref[1]["initial_cost"]


def test_ransac_inside_inference_mode():
    from test_torch_geometry import K, scene, t32
    scenes = [scene(s, 256) for s in (20, 21)]
    p0 = t32(np.stack([s[0] for s in scenes]))
    p1 = t32(np.stack([s[1] for s in scenes]))
    Ks = t32(K)[None].expand(2, 3, 3)

    def run():
        return tr.ransac_essential_batch(
            p0, p1, Ks, Ks, n_hypotheses=128,
            generator=torch.Generator().manual_seed(3))
    ref = run()
    with torch.inference_mode():
        got = run()
    _same(got, ref)
