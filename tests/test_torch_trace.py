"""The port's stage ranges (`utils/profiling.span`) on the CPU: nothing at
all without a profiler; under one, the ranges of `detect_and_compute`,
`lighterglue_forward` and `batch_mnn_match_fused`, nested and in order,
with outputs equal to the bit to those of an unprofiled call. (On the
card, `tests/test_torch_cuda.py` checks that the ranges put no event on
the device's timeline.) Tiny random-weight inputs: 2 images of 64x64,
LighterGlue on 2 pairs of 32 points."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from accelerated_features_tpu_torch.models import lighterglue as lg
from accelerated_features_tpu_torch.models.params import load_params
from accelerated_features_tpu_torch.ops.cuda.mnn import batch_mnn_match_fused
from accelerated_features_tpu_torch.ops.extraction import detect_and_compute
from accelerated_features_tpu_torch.utils import profiling

N_LAYERS = len(lg.init_lighterglue_params(torch.Generator().manual_seed(0))
               ["layers"])


def _inputs():
    gen = torch.Generator().manual_seed(7)
    b, k = 2, 32
    kpts = torch.rand((2, b, k, 2), generator=gen) * 64
    descs = torch.nn.functional.normalize(
        torch.randn((2, b, k, 64), generator=gen), dim=-1)
    valid = torch.rand((2, b, k), generator=gen) > 0.2
    return {
        "images": torch.randint(0, 256, (2, 64, 64, 1), dtype=torch.uint8,
                                generator=gen),
        "lg_params": lg.init_lighterglue_params(gen),
        "kpts": kpts, "descs": descs, "valid": valid,
        "size": torch.tensor([[64.0, 64.0]] * b),
    }


def _calls(params, x):
    def lighterglue(prune, depth=-1.0):
        # pruning_min_kpts=0 turns pruning on at 32 points
        return lg.lighterglue_forward(
            x["lg_params"], x["kpts"][0], x["kpts"][1], x["descs"][0],
            x["descs"][1], x["size"], x["size"], x["valid"][0],
            x["valid"][1], width_confidence=0.95 if prune else -1.0,
            pruning_min_kpts=0, depth_confidence=depth)

    return {
        "extract": lambda: detect_and_compute(params, x["images"], 32, 0.0),
        "lighterglue": lambda: lighterglue(True),
        "lighterglue-unpruned": lambda: lighterglue(False),
        "lighterglue-depth": lambda: lighterglue(True, 0.95),
        "mnn": lambda: dict(zip(("idx1", "mask"), batch_mnn_match_fused(
            x["descs"][0], x["descs"][1], x["valid"][0], x["valid"][1]))),
    }


@pytest.fixture(scope="module")
def runs():
    """Each entry called without a profiler and under a CPU profiler: the
    two outputs and the `xfeat.*` ranges (name, start, end in ns) of the
    profiled call, in the order they started."""
    torch.manual_seed(0)
    calls = _calls(load_params(None), _inputs())
    out = {}
    for name, call in calls.items():
        plain = call()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = call()
        ranges = sorted(
            ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("xfeat.")),
            key=lambda r: (r[1], -r[2]))
        out[name] = (plain, traced, ranges)
    return out


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("xfeat.a"), profiling.span("xfeat.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    # what a session that starts later sees: nothing from before it
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("xfeat.")]


def test_span_reads_the_flag_every_profiler_sets():
    """The gate is the enabled flag that `torch.profiler.profile` and the
    autograd profiler set; under either, a span is a function-scope
    record (no user annotation, which the profiler would project onto
    the device's timeline)."""
    for session in (profile(activities=[ProfilerActivity.CPU]),
                    torch.autograd.profiler.profile()):
        with session:
            assert torch.autograd.profiler._is_profiler_enabled
            s = profiling.span("xfeat.a")
            assert not isinstance(s, contextlib.nullcontext)
            with s:
                pass
        assert not torch.autograd.profiler._is_profiler_enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("xfeat.a"):
            pass
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "xfeat.a"]
    assert not ev.is_user_annotation()


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_extraction_ranges_nest_in_order(runs):
    _, _, ranges = runs["extract"]
    names = [r[0] for r in ranges]
    assert names == ["xfeat.extract", "xfeat.extract.backbone",
                     "xfeat.extract.decode", "xfeat.extract.select",
                     "xfeat.extract.sample"]
    top, children = ranges[0], ranges[1:]
    assert all(_inside(top, c) for c in children)
    assert all(a[2] <= b[1] for a, b in zip(children, children[1:]))


@pytest.mark.parametrize("entry,pruned", [("lighterglue", N_LAYERS - 1),
                                          ("lighterglue-unpruned", 0)])
def test_lighterglue_ranges_per_layer(runs, entry, pruned):
    _, _, ranges = runs[entry]
    names = [r[0] for r in ranges]
    assert names[0] == "xfeat.lighterglue"
    assert all(_inside(ranges[0], r) for r in ranges[1:])
    layer = ["self", "self", "cross"]
    expect = ["embed"]
    for i in range(N_LAYERS):
        expect += layer + (["prune"] if pruned and i < N_LAYERS - 1 else [])
    expect.append("assign")
    assert names[1:] == ["xfeat.lighterglue." + s for s in expect]
    assert names.count("xfeat.lighterglue.prune") == pruned
    inner = ranges[1:]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_lighterglue_confidence_range_only_with_depth(runs):
    """With depth confidence on, `.confidence` (token confidence, exit
    decision, the gate's confidence term) once a layer but the last,
    between the layer's cross-attention and its pruning; never without."""
    _, _, ranges = runs["lighterglue-depth"]
    names = [r[0] for r in ranges]
    assert all(_inside(ranges[0], r) for r in ranges[1:])
    expect = ["embed"]
    for i in range(N_LAYERS):
        expect += ["self", "self", "cross"]
        if i < N_LAYERS - 1:
            expect += ["confidence", "prune"]
    expect.append("assign")
    assert names[1:] == ["xfeat.lighterglue." + s for s in expect]
    inner = ranges[1:]
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))
    for entry in ("lighterglue", "lighterglue-unpruned"):
        assert "xfeat.lighterglue.confidence" not in \
            [r[0] for r in runs[entry][2]]


def test_mnn_range(runs):
    _, _, ranges = runs["mnn"]
    assert [r[0] for r in ranges] == ["xfeat.mnn"]


@pytest.mark.parametrize("entry", ["extract", "lighterglue",
                                   "lighterglue-unpruned", "mnn",
                                   "lighterglue-depth"])
def test_outputs_equal_to_the_bit_under_a_profiler(runs, entry):
    plain, traced, _ = runs[entry]
    assert plain.keys() == traced.keys()
    for k in plain:
        a, b = plain[k], traced[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.is_floating_point():
            a = a.contiguous().view(torch.uint8)
            b = b.contiguous().view(torch.uint8)
        assert torch.equal(a, b), k
