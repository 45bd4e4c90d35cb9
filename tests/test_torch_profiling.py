"""`utils/profiling.py` on the CPU (host clock; the CUDA-event paths run
on the card in `chip_smoke.py`), and `utils/imageio.decode_png` against
`cv2.imdecode`."""

import time

import cv2
import numpy as np
import pytest
import torch

from accelerated_features_tpu_torch.utils import profiling
from accelerated_features_tpu_torch.utils.imageio import decode_png

from torch_support import HOLDOUT_SCENES



def test_time_fn_host_clock():
    calls = []

    def fn(x, scale=1.0):
        calls.append(scale)
        time.sleep(0.002)
        return x * scale

    s = profiling.time_fn(fn, torch.ones(4), iters=5, warmup=2, scale=3.0)
    assert len(calls) == 7 and set(calls) == {3.0}
    assert 0.002 <= s < 0.1


def test_scan_time_inputs_differ_between_iterations():
    """Every floating tensor (nested ones too) differs from one iteration
    to the next; integer tensors only with perturb_ints; other leaves pass
    through."""
    seen = []

    def fn(x, tree, idx, k):
        seen.append((x.clone(), tree["w"][0].clone(), idx.clone(), k))
        return x.sum()

    x = torch.rand(16)
    tree = {"w": [torch.rand(3, 3)]}
    idx = torch.arange(5, dtype=torch.uint8)
    s = profiling.scan_time(fn, x, tree, idx, 7, iters=4, warmup=1,
                            min_window_s=0.0)
    assert s > 0 and len(seen) == 5
    xs = [v[0] for v in seen]
    assert all(not torch.equal(a, b) for a, b in zip(xs, xs[1:]))
    ws = [v[1] for v in seen]
    assert all(not torch.equal(a, b) for a, b in zip(ws, ws[1:]))
    assert all(torch.equal(v[2], idx) and v[3] == 7 for v in seen)
    assert torch.equal(x, xs[0])  # iteration 0 is the input itself
    seen.clear()
    profiling.scan_time(fn, x, tree, idx, 7, iters=2, warmup=1,
                        min_window_s=0.0, perturb_ints=True)
    assert not torch.equal(seen[0][2], seen[1][2])


def test_scan_time_perturbs_namedtuples_and_keeps_their_type():
    """A NamedTuple argument (a BA problem, an optimizer state) comes back
    as its own type with its floating fields perturbed."""
    from accelerated_features_tpu_torch.apps.bench_suite import _synth_ba
    seen = []
    p = _synth_ba(3, 8, 2)
    profiling.scan_time(seen.append, p, iters=2, warmup=1, min_window_s=0.0)
    assert len(seen) == 3 and all(type(q) is type(p) for q in seen)
    assert not torch.equal(seen[1].cams, seen[2].cams)
    assert all(torch.equal(q.obs_cam, p.obs_cam) for q in seen)


def test_count_flops_counts_products_and_convolutions():
    a, b = torch.rand(8, 16), torch.rand(16, 4)
    w = torch.rand(6, 3, 3, 3)
    assert profiling.count_flops(torch.matmul, a, b) == 2 * 8 * 16 * 4
    assert profiling.count_flops(
        torch.nn.functional.conv2d, torch.rand(1, 3, 10, 12), w,
        padding=1) == 2 * 10 * 12 * 6 * 3 * 3 * 3
    assert profiling.count_flops(torch.relu, a) == 0


def test_scan_time_lengthens_a_short_window():
    n = []
    profiling.scan_time(lambda x: n.append(1), torch.ones(2), iters=2,
                        warmup=1, min_window_s=0.01, max_iters=32)
    assert len(n) > 3


def test_roofline_floor_and_speed_of_light():
    assert profiling.roofline_floor_s(67e12, 0.0, "f32") == \
        pytest.approx(1.0)
    assert profiling.roofline_floor_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert profiling.roofline_floor_s(989e12, 3.35e9, "bf16") == \
        pytest.approx(1.0)
    assert profiling.roofline_floor_s(495e12, 0.0, "tf32") == \
        pytest.approx(1.0)
    out = profiling.speed_of_light(2.0, flops=67e12, bytes_moved=3.35e12,
                                   dtype="f32")
    assert out["tflops"] == pytest.approx(33.5)
    assert out["flops_frac_of_peak"] == pytest.approx(0.5)
    assert out["gbps"] == pytest.approx(1675.0)
    assert out["bw_frac_of_peak"] == pytest.approx(0.5)
    assert out["sol_seconds"] == pytest.approx(1.0)
    assert out["sol_frac"] == pytest.approx(0.5)
    assert profiling.speed_of_light(1.0) == {"seconds": 1.0}
    assert profiling.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert profiling.bound(0.0, 495e9, profiling.PEAK_TF32_FLOPS) == \
        (pytest.approx(1.0), "operations")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and b"traceEvents" in files[0].read_bytes()


@pytest.mark.parametrize("name", sorted(
    p.name for p in HOLDOUT_SCENES.rglob("*.png"))[:4])
def test_decode_png_equals_cv2_imdecode(name):
    path = next(HOLDOUT_SCENES.rglob(name))
    data = path.read_bytes()
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = decode_png(data)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_png_equals_cv2_on_encoded_arrays(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img[..., 0] if channels == 1 else img)
    assert ok
    ref = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    assert np.array_equal(decode_png(buf.tobytes()), ref)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(buf.tobytes()[1:])
