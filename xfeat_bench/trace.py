"""The traced run: the benchmark's own spans around each call into the
program, and the device's operations from `torch.profiler`, each tied to
the benchmark span that launched it.

`Tracer` records a span as a `torch.profiler.record_function` range named
`xb.<name>` when tracing and does nothing otherwise. `read_profile` turns
the profiler's raw events into a `Trace` of plain numbers (seconds on the
profiler's clock): the spans, and each device operation (kernel, copy,
set) with the innermost span whose host interval holds its launch.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .timeline import Spans

PREFIX = "xb."


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    span: Optional[str]      # the benchmark span that launched it
    kernel: bool             # False for copies and sets


@dataclass
class Trace:
    spans: List[Tuple[str, float, float]]
    ops: List[DeviceOp]
    unattributed: int = 0    # device operations whose launch was not found

    def window(self) -> Tuple[float, float]:
        """From the start of the first request to the end of the last."""
        req = [s for s in self.spans if s[0] == "request"]
        return (min(s[1] for s in req), max(s[2] for s in req))


@dataclass
class Tracer:
    """Spans around the benchmark's calls into the program. Each span's
    host seconds are kept by name in `host`; with `on`, the span is also
    a profiler range."""
    on: bool = False
    host: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.on:
            from torch.profiler import record_function
            with record_function(PREFIX + name):
                yield
        else:
            yield
        self.host.setdefault(name, []).append(time.perf_counter() - t0)


# CUDA runtime and driver calls: a device operation carries the correlation
# id of the call that launched it; host operations are numbered apart
_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def read_profile(prof) -> Trace:
    """A finished `torch.profiler.profile` -> `Trace`."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    spans, host, runtime, device = [], {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # the profiler also projects the benchmark's spans onto the
            # device's timeline; those are no device operations
            if not name.startswith(PREFIX):
                device.append((name, e.start_ns(),
                               e.start_ns() + e.duration_ns(),
                               e.correlation_id(), e.linked_correlation_id()))
            continue
        if name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], e.start_ns() / 1e9,
                          (e.start_ns() + e.duration_ns()) / 1e9))
        cid = e.correlation_id()
        if cid:
            (runtime if _RUNTIME.match(name) else host)[cid] = \
                e.start_ns() / 1e9
    where = Spans(spans)
    ops, lost = [], 0
    for name, a, b, cid, link in device:
        # the launching runtime call (same correlation id), else the host
        # operation the profiler links the device operation to
        t = runtime.get(cid) if cid else None
        if t is None and link:
            t = host.get(link)
        if t is None:
            lost += 1
        ops.append(DeviceOp(name, a / 1e9, b / 1e9,
                            None if t is None else where.innermost(t),
                            not _is_copy(name)))
    return Trace(spans, ops, lost)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the idle
    time of the device inside the window by the benchmark span the host
    was in (`between` outside every span but the request's)."""
    from .timeline import gaps
    window = trace.window()
    by_op: Dict[str, float] = {}
    for op in trace.ops:
        a, b = max(op.start, window[0]), min(op.end, window[1])
        if b > a:
            by_op[op.name] = by_op.get(op.name, 0.0) + (b - a)
    where = Spans(trace.spans)
    edges = sorted({t for _, a, b in trace.spans for t in (a, b)})
    by_span: Dict[str, float] = {}
    for a, b in gaps([(op.start, op.end) for op in trace.ops], window):
        cuts = edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges,
                                                                      b)]
        for lo, hi in zip([a] + cuts, cuts + [b]):
            name = where.innermost((lo + hi) / 2) or "between"
            if name == "request":
                name = "between"
            by_span[name] = by_span.get(name, 0.0) + (hi - lo)

    def ranked(d):
        return [[k[:160], v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
