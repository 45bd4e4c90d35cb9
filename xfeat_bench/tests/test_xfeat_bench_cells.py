"""One run of each cell on the CPU at a tiny size, through the port's CPU
path: `correct` comes out true, and every number compared equals, to the
bit, what the same run read on commit
84259caaa7eac0754cde8600687cf4adebc75c3a, before the harness found its
request kinds, entries and check in a pipeline file. Then the same runs
with the timed path broken underneath (half of the batch left out; one
answer altered where it is produced), and with the control (the
reference at TF32) in the program's place: `correct` comes out false."""

import pytest
import torch

from accelerated_features_tpu_torch.models import lighterglue as port_lg
from accelerated_features_tpu_torch.ops import extraction as port_ex
from accelerated_features_tpu_torch.ops.cuda import mnn as port_mnn
from xfeat_bench.harness import run_cell

SEED = 2 ** 31 + 77
CROP = (96, 128)
TINY = {
    "sparse.extract-b64": {"views_per_request": 4, "distinct_requests": 2,
                           "top_k": 64},
    "lg.pairs-k4096-b8": {"pairs_per_request": 2, "distinct_requests": 2,
                          "top_k": 64},
    "sparse.mnn-block50": {"views_per_block": 4, "pairs_per_chunk": 4,
                           "distinct_requests": 2, "top_k": 64},
    "lg.pairs-k1024-b32": {"pairs_per_request": 2, "distinct_requests": 2,
                           "top_k": 32},
}

CHECKS_AT_84259CA = {
    "sparse.extract-b64": {"select_gap": 0.0,
                           "score_gap": 1.1622905731201172e-06,
                           "desc_gap": 6.109476089477539e-07},
    "lg.pairs-k4096-b8": {"select_gap": 0.0,
                          "score_gap": 1.4007091522216797e-06,
                          "desc_gap": 6.258487701416016e-07,
                          "matcher_gap": 0.0,
                          "mscore_gap": 2.384185791015625e-07},
    "sparse.mnn-block50": {"mnn_gap": 0.0},
    "lg.pairs-k1024-b32": {"select_gap": 0.0,
                           "score_gap": 1.4007091522216797e-06,
                           "desc_gap": 5.252659320831299e-07,
                           "matcher_gap": 0.0,
                           "mscore_gap": 8.642673492431641e-07},
}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _run(cell, program=None, crop=CROP, traffic=None, trace=False):
    kw = {} if program is None else {"program": program}
    return run_cell(cell, SEED, 0.05, trace, "cpu",
                    overrides={"traffic": traffic or TINY[cell],
                               "crop_hw": crop}, **kw)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_one_request_of_each_cell(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert list(r)[-1] == "checks" and r["checks"]
    assert "setup_s" in r["metrics"] and "request_ms_p95" in r["metrics"]
    assert {k: c["value"] for k, c in r["checks"].items()} == \
        CHECKS_AT_84259CA[cell]


def test_a_traced_run_reads_per_layer_metrics():
    r = _run("sparse.extract-b64", trace=True)
    assert r["correct"]
    assert "setup_s" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _half_extraction(fn):
    def broken(params, images, *a, **k):
        out = dict(fn(params, images, *a, **k))
        h = images.shape[0] // 2
        out["valid"] = out["valid"].clone()
        out["valid"][h:] = False
        out["scores"] = torch.where(out["valid"], out["scores"], -1.0)
        return out
    return broken


def _moved_keypoint(fn):
    def broken(params, images, *a, **k):
        out = dict(fn(params, images, *a, **k))
        kp = out["keypoints"].clone()
        kp[0, 0, 0] += 1.0
        out["keypoints"] = kp
        return out
    return broken


def _half_mnn(fn):
    def broken(d1, d2, v1, v2, *a, **k):
        idx, mask = fn(d1, d2, v1, v2, *a, **k)
        mask = mask.clone()
        mask[d1.shape[0] // 2:] = False
        return idx, mask
    return broken


def _altered_mnn(fn):
    def broken(d1, d2, v1, v2, *a, **k):
        idx, mask = fn(d1, d2, v1, v2, *a, **k)
        row = int(torch.nonzero(mask[0])[0, 0])
        idx = idx.clone()
        idx[0, row] = (idx[0, row] + 1) % d2.shape[1]
        return idx, mask
    return broken


def _half_lighterglue(fn):
    def broken(*a, **k):
        out = dict(fn(*a, **k))
        h = out["matches0"].shape[0] // 2
        out["matches0"] = out["matches0"].clone()
        out["matches0"][h:] = -1
        return out
    return broken


def _altered_lighterglue(fn):
    def broken(*a, **k):
        out = dict(fn(*a, **k))
        m = out["matches0"].clone()
        row = int(torch.nonzero(m[0] >= 0)[0, 0])
        m[0, row] = (m[0, row] + 1) % int(a[4][0].shape[0] // 2)
        out["matches0"] = m
        return out
    return broken


FAULTS = [
    ("sparse.extract-b64", port_ex, "detect_and_compute", _half_extraction),
    ("sparse.extract-b64", port_ex, "detect_and_compute", _moved_keypoint),
    ("lg.pairs-k1024-b32", port_ex, "detect_and_compute", _half_extraction),
    ("sparse.mnn-block50", port_mnn, "batch_mnn_match_fused", _half_mnn),
    ("sparse.mnn-block50", port_mnn, "batch_mnn_match_fused", _altered_mnn),
    ("lg.pairs-k4096-b8", port_lg, "lighterglue_forward", _half_lighterglue),
    ("lg.pairs-k4096-b8", port_lg, "lighterglue_forward",
     _altered_lighterglue),
    ("lg.pairs-k1024-b32", port_lg, "lighterglue_forward",
     _altered_lighterglue),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, module, name,
                                            fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["sparse.extract-b64", "lg.pairs-k4096-b8",
                                  "lg.pairs-k1024-b32"])
def test_the_control_is_not_correct(cell):
    r = _run(cell, program="Control")
    assert not r["correct"], r["checks"]


def test_the_control_is_not_correct_for_mnn():
    # TF32 flips mutual matches only where two similarities lie within its
    # rounding: a block of six views at 1024 points has such rows
    r = _run("sparse.mnn-block50", program="Control", crop=(288, 384),
             traffic={"views_per_block": 6, "pairs_per_chunk": 8,
                      "distinct_requests": 1, "top_k": 1024})
    assert not r["correct"], r["checks"]
