"""`stages.py`: the program's `xfeat.*` ranges read from the profiler's
events beside the benchmark's trace, and their reductions, against
hand-worked numbers; then one traced window of tiny cells on the CPU."""

import pytest
import torch

from xfeat_bench import stages
from xfeat_bench.trace import read_profile

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    """A profiler event as `read_profile` reads one (times in ms here)."""

    def __init__(self, name, start, end, device=CPU, cid=0, link=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._cid, self._link = device, cid, link

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return int(self._start * 1e6)

    def duration_ns(self):
        return int((self._end - self._start) * 1e6)

    def correlation_id(self):
        return self._cid

    def linked_correlation_id(self):
        return self._link


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})})()


def _request(t, cid):
    """One request of 100 ms at t: the benchmark's spans, the program's
    ranges inside `match`, a launch in each range and one outside them,
    and the device operations they launch (one projected `xb.` range on
    the device, which no reader counts)."""
    return [
        Event("xb.request", t, t + 100),
        Event("xb.extract", t, t + 40),
        Event("xfeat.extract", t + 1, t + 39),
        Event("xfeat.extract.backbone", t + 2, t + 30),
        Event("cudaLaunchKernel", t + 3, t + 4, cid=cid),
        Event("conv", t + 5, t + 25, CUDA, cid=cid),
        Event("xb.match", t + 40, t + 90),
        Event("xfeat.lighterglue", t + 42, t + 88),
        Event("xfeat.lighterglue.assign", t + 60, t + 80),
        Event("cudaLaunchKernel", t + 61, t + 62, cid=cid + 1),
        Event("softmax", t + 70, t + 75, CUDA, cid=cid + 1),
        Event("cudaLaunchKernel", t + 43, t + 44, cid=cid + 2),
        Event("attn", t + 45, t + 55, CUDA, cid=cid + 2),
        Event("cudaMemcpyAsync", t + 89, t + 89.5, cid=cid + 3),
        Event("Memcpy DtoH", t + 92, t + 95, CUDA, cid=cid + 3),
        Event("xb.match", t + 46, t + 54, CUDA),
    ]


@pytest.fixture
def prof():
    return Prof(_request(0.0, 10) + _request(100.0, 20))


def test_read_stages_keeps_the_trace_s_operations(prof):
    trace, got = read_profile(prof), stages.read_stages(prof)
    assert [(o.name, o.start, o.end, o.kernel) for o in got.ops] == \
        [(o.name, o.start, o.end, o.kernel) for o in trace.ops]
    assert len(trace.ops) == 8          # the projected `xb.` range skipped
    assert {s[0] for s in trace.spans} == {"request", "extract", "match"}
    assert {s[0] for s in got.spans} == {
        "extract", "extract.backbone", "lighterglue", "lighterglue.assign"}
    assert [o.span for o in trace.ops[:4]] == [
        "extract", "match", "match", "match"]
    assert [o.span for o in got.ops[:4]] == [
        "extract.backbone", "lighterglue.assign", "lighterglue", None]


def test_stage_readings(prof):
    trace, got = read_profile(prof), stages.read_stages(prof)
    # 20 ms of convs a request, 2 requests of 8 pairs
    assert stages.stage_device_ms(got, "extract.backbone", 16) == \
        pytest.approx(2 * 20 / 16)
    assert stages.stage_device_ms(got, "extract", 16) == \
        pytest.approx(2 * 20 / 16)
    assert stages.stage_device_ms(got, "lighterglue.assign", 16) == \
        pytest.approx(2 * 5 / 16)
    assert stages.stage_device_ms(got, "lighterglue", 16) == \
        pytest.approx(2 * 15 / 16)
    assert stages.stage_device_ms(got, "mnn", 16) is None
    window = trace.window()
    assert window == (0.0, 0.2)
    assert stages.stage_host_ms(got, stages.MATCHER, window, 16) == \
        pytest.approx(2 * 46 / 16)
    # idle inside `lighterglue` (42-88): 42-45, 55-70, 75-88 = 31 ms
    assert stages.stage_idle_pct(trace.ops, got, stages.MATCHER,
                                 window) == pytest.approx(100 * 62 / 200)
    r = stages.readings(trace, got, "pairs", 16)
    assert r == {"backbone_device_ms.pairs": pytest.approx(2.5),
                 "assignment_device_ms.pairs": pytest.approx(0.625),
                 "matcher_host_ms.pairs": pytest.approx(5.75),
                 "matcher_idle.pairs": pytest.approx(31.0)}


def test_idle_by_stage_cuts_gaps_at_range_edges(prof):
    trace, got = read_profile(prof), stages.read_stages(prof)
    idle_ms = {k: 1e3 * v for k, v in stages.idle_stages(trace, got)}
    # a request: idle 0-5, 25-45, 55-70, 75-92, 95-100 (62 ms)
    assert idle_ms == pytest.approx({
        "outside:extract": 2 * (1 + 1),          # 0-1, 39-40
        "extract": 2 * (1 + 9),                  # 1-2, 30-39
        "extract.backbone": 2 * (3 + 5),         # 2-5, 25-30
        "outside:match": 2 * (2 + 2),            # 40-42, 88-90
        "lighterglue": 2 * (3 + 5 + 8),          # 42-45, 55-60, 80-88
        "lighterglue.assign": 2 * (10 + 5),      # 60-70, 75-80
        "outside:between": 2 * (2 + 5),          # 90-92, 95-100
    })
    assert sum(idle_ms.values()) == pytest.approx(2 * 62)


def test_a_program_without_ranges_reads_nothing(prof):
    plain = Prof([e for e in prof.profiler.kineto_results.events()
                  if not e.name().startswith("xfeat.")])
    trace, got = read_profile(plain), stages.read_stages(plain)
    assert got.spans == [] and all(o.span is None for o in got.ops)
    assert all(v is None for v in
               stages.readings(trace, got, "pairs", 16).values())


@pytest.mark.parametrize("cell,traffic,ranges", [
    ("sparse.extract-b64", {"views_per_request": 2, "distinct_requests": 2,
                            "top_k": 32}, 5),
    # unpruned at 32 points: extract 5, then 1 + embed + 6 x (2 + 1) +
    # assign
    ("lg.pairs-k1024-b32", {"pairs_per_request": 1, "distinct_requests": 2,
                            "top_k": 32}, 5 + 21),
    # 4 views: 6 pairs, 4 a chunk
    ("sparse.mnn-block50", {"views_per_block": 4, "pairs_per_chunk": 4,
                            "distinct_requests": 2, "top_k": 32}, 2),
])
def test_a_traced_window_on_the_cpu(cell, traffic, ranges):
    torch.set_num_threads(1)
    r = stages.measure(cell, 2 ** 31 + 5, 0.01, "cpu",
                       overrides={"traffic": traffic, "crop_hw": (64, 96)})
    assert r["requests"] >= 2 and r["window_s"] > 0
    assert r["stage_ranges_per_request"] == ranges
    # no device operations on the CPU: every device reading is absent
    assert r["idle_pct"] is None and r["launches"] is None
    assert r["stage_device_ms"] == {}
    per = "images" if cell.startswith("sparse.extract") else "pairs"
    assert r["readings"][f"backbone_device_ms.{per}"] is None
    if per == "pairs":
        assert r["readings"]["matcher_host_ms.pairs"] > 0
        assert r["readings"]["matcher_idle.pairs"] is None
