"""Profiling and speed-of-light accounting for the PyTorch port
(counterpart of the JAX package's `utils/profiling.py`).

- `device_trace`: a `torch.profiler` trace (CPU and CUDA activities),
  written into a directory as a Chrome trace.
- `span`: a named range of the program's own stages (`xfeat.*`) in the
  trace of any running `torch.profiler` session, and nothing otherwise.
- `time_fn`: steady-state seconds a call, between CUDA events where a
  card is present (synchronized, after a warmup), by the host clock
  without one.
- `scan_time`: the same over a loop whose inputs are perturbed every
  iteration, so no cache keyed on the inputs can skip the work.
- `roofline_floor_s`, `speed_of_light`, `bound`: the least time an
  operation count and a byte count can take on one H100 SXM, and the share
  of it a measured time reaches.
- `count_flops`: the operations of one call, counted by torch's
  `FlopCounterMode` (run it on the plain path: the count of the
  function's work, whatever kernel computes it on the card).
- `time_ms`, `profile_call`, `median_wall_ms`: the card-only timers of
  `chip_smoke.py` (device time with a cold L2, device busy time and idle
  share of one call, host walls ended by a synchronize).

The peaks are NVIDIA's data-sheet numbers for the H100 SXM at its 700 W
limit (dense, no sparsity). A card set to a lower power limit runs below
them; print the limit beside every number.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

# H100 SXM peaks: HBM bytes/s, fp32 FLOP/s on the CUDA cores (no tensor
# cores), dense TF32 and bf16 FLOP/s on the tensor cores. A float32-grade
# product on the tensor cores takes three TF32 products (3xTF32), so its
# operations count three times against PEAK_TF32_FLOPS.
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_FLOPS = {"f32": PEAK_F32_FLOPS, "tf32": PEAK_TF32_FLOPS,
              "bf16": PEAK_BF16_FLOPS}


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace what runs inside the block with `torch.profiler` (CPU ops and,
    when a card is present, its kernels) and write a Chrome trace
    (`trace_<pid>_<ns>.json`, for chrome://tracing or Perfetto) into
    `logdir`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` as a range of the running profiler's
    trace, timestamped on the profiler's own clock (the clock its device
    records are placed on). With no profiler running it is one shared
    no-op context, after a single read of the profiler's enabled flag:
    no range object, no allocation, no device call.

    The range is a plain function-scope record (`_RecordFunctionFast`),
    not a `record_function` user annotation: the profiler projects user
    annotations onto the device timeline as events of their own, which a
    reader of the device trace would take for device operations, and a
    user annotation costs several times more to enter. Spans of one call
    nest inside the caller's ranges. An operator sees them by tracing,
    with `device_trace` or any `torch.profiler` session, in the host
    timeline of the Chrome or Perfetto view, each kernel tied to its
    launch."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


def _timed_loop(run: Callable[[int], Any], iters: int) -> float:
    """Seconds for run(0) ... run(iters - 1): between CUDA events after a
    synchronize where a card is present, by the host clock without one."""
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for i in range(iters):
            run(i)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        run(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3,
            **kwargs) -> float:
    """Steady-state seconds a call of fn(*args, **kwargs), over `iters`
    calls after `warmup` calls. With a card present the calls run between
    two CUDA events, after a synchronize, and the time is the device's;
    without one it is the host clock's."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    return _timed_loop(lambda i: fn(*args, **kwargs), iters) / iters


def _leaves(tree: Any, out: List[Any]) -> List[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return next(leaves)


_SAME_WIDTH_INT = {torch.float64: torch.int64, torch.float32: torch.int32,
                   torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _perturbed(args: Any, i: int, perturb_ints: bool = False) -> Any:
    """`args` (tensors in nested tuples, NamedTuples, lists and dicts)
    with iteration `i`'s perturbation: every floating tensor moved by
    i % 16 units in the last place (a relative change below 16 * eps of
    its dtype), and with `perturb_ints` every integer tensor plus i % 2
    (wrapping in its dtype). Other leaves are passed as they are."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype in _SAME_WIDTH_INT:
            return (x.view(_SAME_WIDTH_INT[x.dtype]) + i % 16).view(x.dtype)
        if perturb_ints and not torch.is_floating_point(x) \
                and x.dtype != torch.bool:
            return x + (i % 2)
        return x
    return _rebuild(args, iter([one(x) for x in _leaves(args, [])]))


def scan_time(fn: Callable, *args, iters: int = 20, warmup: int = 1,
              min_window_s: float = 0.05, max_iters: int = 2048,
              perturb_ints: bool = False) -> float:
    """Steady-state seconds a call of fn(*args), over a loop whose inputs
    differ from one iteration to the next (the JAX function of this name
    times an XLA scan; the contract kept is that no iteration may reuse
    the work of the one before).

    Iteration i (warmup included, counted across the whole run) moves
    every floating tensor in `args` (nested tuples, NamedTuples, lists and
    dicts too) by i % 16 units in the last place and, with
    `perturb_ints=True`, adds i % 2 to every integer tensor (turn it on
    when an integer tensor carries the bulk data, such as uint8 frames; it
    changes the meaning of index tensors). The perturbation runs inside
    the timed loop: one elementwise pass over each perturbed input an
    iteration, part of the time returned. The loop is lengthened (4x a
    step, up to `max_iters`) until it lasts `min_window_s`; with
    `min_window_s=0` it runs exactly `warmup + iters` calls, as ranks that
    meet in collectives must. Timed as `time_fn` times: on the card the
    time between two CUDA events, so it includes every gap in which the
    card waits for the host (an eager loop, not one compiled program).
    """
    step = itertools.count()

    def run(_):
        return fn(*_perturbed(args, next(step), perturb_ints))

    for _ in range(max(warmup, 1)):
        run(0)
    while True:
        total = _timed_loop(run, iters)
        if total >= min_window_s or iters >= max_iters:
            return total / iters
        iters = min(iters * 4, max_iters)


def roofline_floor_s(flops: float = 0.0, bytes_moved: float = 0.0,
                     dtype: str = "f32") -> float:
    """Least seconds one H100 SXM takes for `flops` operations at the peak
    of `dtype` ("f32": CUDA cores, "tf32" or "bf16": tensor cores) and for
    moving `bytes_moved` bytes at the HBM rate: the larger of the two.
    The caller counts both (each input read once, each output written
    once); there is no compiler cost analysis to ask."""
    return max(flops / PEAK_FLOPS[dtype], bytes_moved / PEAK_HBM_BYTES)


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """Operations of one fn(*args, **kwargs) call, as
    `torch.utils.flop_counter.FlopCounterMode` counts them: two a
    multiply-add of every matrix product, batched product, convolution and
    attention the call dispatches (a backward inside the call too);
    elementwise work, reductions, sorts and gathers count nothing. The
    call runs in full. Run it on the plain path (CPU tensors): the count
    is the function's work, not a kernel's, so a floor taken from it
    (`roofline_floor_s(count, dtype="bf16")`) holds whatever kernel later
    computes the function on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def speed_of_light(seconds: float, flops: float = 0.0,
                   bytes_moved: float = 0.0, dtype: str = "f32"
                   ) -> Dict[str, float]:
    """Rates a measured time reaches, their shares of the H100 SXM's
    peaks, and the roofline floor with the share of it reached."""
    peak = PEAK_FLOPS[dtype]
    out: Dict[str, float] = {"seconds": seconds}
    if flops:
        out["tflops"] = flops / seconds / 1e12
        out["flops_frac_of_peak"] = flops / seconds / peak
    if bytes_moved:
        out["gbps"] = bytes_moved / seconds / 1e9
        out["bw_frac_of_peak"] = bytes_moved / seconds / PEAK_HBM_BYTES
    if flops or bytes_moved:
        floor = roofline_floor_s(flops, bytes_moved, dtype)
        out["sol_seconds"] = floor
        out["sol_frac"] = floor / seconds if seconds else 0.0
    return out


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
          ) -> Tuple[float, str]:
    """(least time in ms, what bounds it) for moving `nbytes` once and
    doing `flops` operations on one H100, at the fp32 CUDA-core peak
    unless another peak is given for the operands' type."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn: Callable[[], Any], iters: int = 50) -> float:
    """Mean device time of one fn() call on the card with a cold L2, over
    `iters` calls. Before each call a 256 MB write evicts the 50 MB L2, so
    inputs come from HBM, as `bound` assumes; each call is timed between
    its own pair of CUDA events. A spin kernel queued first keeps the card
    busy while the host enqueues everything, so host-side launch cost
    (Python, ctypes) does not show as device time."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.zero_()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0  # host + device, an upper bound
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * per_call_s * iters * 1.5))  # ~2 GHz cycles
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def profile_call(name: str, fn: Callable[[], Any], keep=None) -> Any:
    """Print where the time of one fn() call on the card goes, by device
    kernel: the call's host wall (ended by a synchronize), the device's
    busy time (the union of kernel intervals, from every thread of the
    process), the kernel count, the idle share 1 - busy / wall and the
    15 kernels that took longest. Returns fn()'s result. With `keep`, print only
    when keep(result)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if keep is not None and not keep(result):
        return result
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, reach = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals, us
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    by_name: Dict[str, Tuple[int, float]] = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    print(f"profile {name}: wall {wall:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({len(kernels)} kernels), idle share "
          f"{1 - busy / 1e3 / wall:.3f}")
    for kname, (n, t) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"  {t / 1e3:8.4f} ms  x{n:<3d} {kname[:100]}")
    return result


def median_wall_ms(fn: Callable[[], Any], calls: int = 5
                   ) -> Tuple[List[float], float]:
    """Host-clock times of `calls` fn() calls on the card, each ended by a
    device synchronize: (all of them, their median)."""
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, sorted(walls)[calls // 2]
