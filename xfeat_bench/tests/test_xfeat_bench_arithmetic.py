"""The window's and the trace's arithmetic against hand-worked numbers."""

import math

import pytest

from xfeat_bench import counts, peaks, readers
from xfeat_bench.harness import Traced
from xfeat_bench.timeline import Spans, gaps, percentile, union_length
from xfeat_bench.trace import DeviceOp, Trace, breakdown


def test_percentile_interpolates_between_ranks():
    xs = [float(v) for v in range(1, 21)]          # 1 .. 20
    # rank (20 - 1) * 0.95 = 18.05 -> 19 + 0.05 * (20 - 19)
    assert percentile(xs, 95) == pytest.approx(19.05)
    assert percentile([7.0], 95) == 7.0
    assert percentile([3.0, 1.0, 2.0], 50) == 2.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_union_and_gaps_clip_to_the_window():
    ops = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    window = (0.0, 10.0)
    # busy 1-4 and 6-7 and 9-10: 3 + 1 + 1
    assert union_length(ops, window) == pytest.approx(5.0)
    assert gaps(ops, window) == [(0.0, 1.0), (4.0, 6.0), (7.0, 9.0)]
    assert gaps([], (0.0, 2.0)) == [(0.0, 2.0)]


def test_innermost_span():
    s = Spans([("request", 0.0, 10.0), ("extract", 1.0, 4.0),
               ("match", 4.0, 9.0), ("request", 10.0, 20.0)])
    assert s.innermost(2.0) == "extract"
    assert s.innermost(4.0) == "match"
    assert s.innermost(9.5) == "request"
    assert s.innermost(25.0) is None


def _run():
    """Two requests of 64 images in a 0.1 s window: the device busy 0.06 s
    of it; kernel A 2 ms; 10 kernels and 2 copies."""
    spans = [("request", 0.0, 0.05), ("extract", 0.001, 0.04),
             ("request", 0.05, 0.1), ("extract", 0.051, 0.09)]
    ops = []
    for r in (0.0, 0.05):
        ops.append(DeviceOp("Memcpy HtoD", r, r + 0.005, "upload", False))
        for i in range(4):
            ops.append(DeviceOp("conv", r + 0.005 + 0.005 * i,
                                r + 0.01 + 0.005 * i, "extract", True))
        ops.append(DeviceOp("detect_candidates_kernel", r + 0.025,
                            r + 0.026, "extract", True))
        ops.append(DeviceOp("select_kernel", r + 0.026, r + 0.027,
                            "extract", True))
    ops.append(DeviceOp("late", 0.2, 0.3, "extract", True))  # outside
    trace = Trace(spans, ops)
    work = [{"images": 64, "pairs": 0, "flops": 64 * 4.151424e9,
             "detect_bytes": 64 * counts.detect_bytes(608, 800, 4096)}] * 2
    return Traced(trace, trace.window(), work)


def test_readers_on_a_hand_made_timeline():
    run = _run()
    # busy per request: 0.005 copy + 0.020 convs + 0.002 A = 0.027 s
    assert readers.busy_s(run.trace) == pytest.approx(0.054)
    assert readers.idle_pct(run) == pytest.approx(46.0)
    flops = 2 * 64 * 4.151424e9
    assert readers.mfu_pct(run) == pytest.approx(
        100 * flops / (0.1 * peaks.TF32_FLOPS))
    # extract span: 0.022 s of device time a request (the late op too:
    # launched in the span, counted by what it ran), over 128 images
    assert readers.span_device_ms(run, "extract", "images") == \
        pytest.approx(1e3 * (2 * 0.022 + 0.1) / 128)
    bound = 2 * 64 * (4 * 608 * 800 + 4 * 76 * 100 + 4096 * 20) \
        / peaks.HBM_BYTES
    assert readers.roofline_pct(
        run, r"detect_candidates_kernel|select_kernel",
        lambda w: w["detect_bytes"] / peaks.HBM_BYTES) == \
        pytest.approx(100 * bound / 0.004)
    assert readers.launches_per_request(run) == pytest.approx(13 / 2)
    assert readers.roofline_pct(run, "no_such_kernel",
                                lambda w: 1.0) is None


def test_breakdown_names_the_host_span_of_each_gap():
    b = breakdown(_run().trace)
    names = dict(b["idle_gaps"])
    # per request: 0.027-0.05 idle while the host sits in `extract` until
    # 0.04 and in `request` (between calls) after it
    assert names["extract"] == pytest.approx(2 * 0.013)
    assert names["between"] == pytest.approx(2 * 0.010)
    assert b["device_ops"][0][0] == "conv"


def test_counts():
    # XFeat at 800x608, the issue's CPU count from FlopCounterMode
    assert counts.xfeat_flops(608, 800) == 4151424000.0
    assert counts.xfeat_flops(480, 640) == 2621952000.0
    assert counts.mnn_flops(4096, 4000) == 2 * 4096 * 4000 * 64
    assert counts.attention_launches([(3, 5)]) == [(3, 3), (5, 5), (3, 5),
                                                   (5, 3)]
    conf = {"input_dim": 64, "descriptor_dim": 96}
    one = counts.lighterglue_flops(conf, [(10, 20)], [(False, False)])
    d = 96
    by_hand = (2 * 30 * (64 * d + d) + 2 * 30 * 19 * d * d
               + 4 * d * (100 + 400 + 200 + 200)
               + 2 * 30 * (d * d + d) + 2 * 10 * 20 * d)
    assert one == by_hand
    assert not math.isnan(one)
