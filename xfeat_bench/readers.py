"""Reductions from a traced run to per-layer numbers, shared by the
metric files in `metrics/`. Each returns None where the trace holds
nothing to read (no device operation, no kernel of the name, no work of
the kind), never 0 for a share of a peak."""

from __future__ import annotations

import re
from typing import Callable, Optional

from . import peaks
from .timeline import union_length


def busy_s(trace) -> float:
    """Seconds inside the window in which some device operation ran."""
    return union_length([(op.start, op.end) for op in trace.ops],
                        trace.window())


def idle_pct(run) -> Optional[float]:
    if not run.trace.ops:
        return None
    a, b = run.window
    return 100.0 * (1.0 - busy_s(run.trace) / (b - a))


def _total(run, key: str) -> float:
    return sum(w.get(key, 0.0) for w in run.work)


def mfu_pct(run) -> Optional[float]:
    """The model's operations of the window's requests over the window at
    the TF32 peak."""
    flops = _total(run, "flops")
    if not run.trace.ops or flops <= 0:
        return None
    a, b = run.window
    return 100.0 * flops / ((b - a) * peaks.TF32_FLOPS)


def span_device_ms(run, span: str, per: str) -> Optional[float]:
    """Device ms of the operations launched inside the benchmark span
    `span`, per image or pair of the window."""
    n = _total(run, per)
    ops = [op for op in run.trace.ops if op.span == span]
    if not ops or n <= 0:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / n


def kernel_s(run, pattern: str) -> float:
    rx = re.compile(pattern)
    return sum(op.end - op.start for op in run.trace.ops
               if op.kernel and rx.search(op.name))


def roofline_pct(run, pattern: str,
                 bound: Callable[[dict], float]) -> Optional[float]:
    """The least time the window's work of a kernel can take, summed over
    the requests, over the time its kernels (matched by `pattern`) ran."""
    t = kernel_s(run, pattern)
    least = sum(bound(w) for w in run.work)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t


def launches_per_request(run) -> Optional[float]:
    kernels = sum(1 for op in run.trace.ops if op.kernel)
    if not kernels or not run.work:
        return None
    return kernels / len(run.work)
