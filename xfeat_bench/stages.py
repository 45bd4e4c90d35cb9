"""The program's own ranges in a traced window of a cell: where inside the
port's extraction, LighterGlue and MNN entries the device time, the host
time and the device's idle time go.

The port marks its stages as profiler ranges named `xfeat.<stage>`
(`utils/profiling.span` in `accelerated_features_tpu_torch`): `extract`
holding `extract.backbone`, `.decode`, `.select` and `.sample`;
`lighterglue` holding `lighterglue.embed`, `.self`, `.cross`, `.prune`
and `.assign`; `mnn`. `trace.read_profile` keeps the benchmark's own
`xb.` ranges only, and the per-layer metrics of `BENCHMARK.json` read
nothing else. This module reads the same profiler a second time with the
program's ranges in the place of the benchmark's (`read_stages`), and
reduces that:

- `stage_device_ms`: device ms of the operations launched inside a stage
  (its name or a name below it), per image or pair;
- `stage_host_ms`: host ms inside ranges of given names, per pair;
- `stage_idle_pct`: % of the window with no device operation while the
  host is inside ranges of given names;
- `idle_stages`: the window's idle seconds by the innermost program range
  the host was in, or `outside:<the benchmark's span>` where it was in
  none.

On a program without the ranges each returns None (or nothing).

    python3 xfeat_bench/stages.py --workload <name> --seed <n> \
        [--seconds 10] [--out FILE]

runs the cell's set-up and warm-up as a run does, then one traced window
of `--seconds` on the card, and prints the readings as one JSON line (and
appends it to `--out`). It judges no answer; `run.py` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Iterable, List, Optional, Tuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if __name__ == "__main__":      # run as a script: import by package
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

from xfeat_bench import trace as trace_mod  # noqa: E402
from xfeat_bench.timeline import Spans, gaps, union_length  # noqa: E402

PREFIX = "xfeat."
MATCHER = ("lighterglue", "mnn")


class _Renamed:
    """A profiler event under another name."""

    def __init__(self, event, name: str):
        self._event, self._name = event, name

    def name(self) -> str:
        return self._name

    def __getattr__(self, attr):
        return getattr(self._event, attr)


def _host_renamed(events: Iterable, device_type) -> List:
    """Host events with the program's ranges named as the benchmark's and
    the benchmark's ranges named apart; device events as they are, so
    that the device operations read are the same ones."""
    out = []
    bench = trace_mod.PREFIX
    for e in events:
        name = e.name()
        if e.device_type() != device_type:
            if name.startswith(bench):
                e = _Renamed(e, "bench:" + name[len(bench):])
            elif name.startswith(PREFIX):
                e = _Renamed(e, bench + name[len(PREFIX):])
        out.append(e)
    return out


def read_stages(prof) -> trace_mod.Trace:
    """A finished profiler, read by `trace.read_profile` with the program's
    ranges in the place of the benchmark's: `spans` are the `xfeat.*`
    ranges (prefix dropped), `ops` the same device operations as the
    benchmark's trace of `prof`, each with the innermost program range
    around its launch as its `span` (None outside every range)."""
    import torch
    events = _host_renamed(prof.profiler.kineto_results.events(),
                           torch.autograd.DeviceType.CUDA)
    return trace_mod.read_profile(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events))))


def _under(stage: Optional[str], prefix: str) -> bool:
    return stage is not None and (stage == prefix
                                  or stage.startswith(prefix + "."))


def stage_device_ms(stages: trace_mod.Trace, prefix: str,
                    units: int) -> Optional[float]:
    """Device ms of the operations launched inside stage `prefix` or a
    stage below it, per unit (image or pair)."""
    ops = [op for op in stages.ops if _under(op.span, prefix)]
    if not ops or units <= 0:
        return None
    return 1e3 * sum(op.end - op.start for op in ops) / units


def _ranges(stages: trace_mod.Trace, names: Iterable[str]
            ) -> List[Tuple[float, float]]:
    names = set(names)
    return [(a, b) for n, a, b in stages.spans if n in names]


def stage_host_ms(stages: trace_mod.Trace, names: Iterable[str],
                  window: Tuple[float, float], units: int
                  ) -> Optional[float]:
    """Host ms inside the ranges named `names` (their union, clipped to
    the window), per unit."""
    ranges = _ranges(stages, names)
    if not ranges or units <= 0:
        return None
    return 1e3 * union_length(ranges, window) / units


def _overlap(xs: List[Tuple[float, float]],
             ys: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def stage_idle_pct(ops: List[trace_mod.DeviceOp], stages: trace_mod.Trace,
                   names: Iterable[str], window: Tuple[float, float]
                   ) -> Optional[float]:
    """% of the window in which no device operation of `ops` ran while the
    host was inside a range named in `names`."""
    ranges = _ranges(stages, names)
    if not ops or not ranges:
        return None
    idle = gaps([(op.start, op.end) for op in ops], window)
    inside = gaps(gaps(ranges, window), window)    # the ranges' union
    return 100.0 * _overlap(idle, inside) / (window[1] - window[0])


def idle_stages(trace: trace_mod.Trace, stages: trace_mod.Trace,
                top: int = 16) -> List[list]:
    """The idle seconds of `trace`'s window by the innermost program range
    the host was in, or, outside every program range, by the benchmark's
    span (`outside:<span>`; `outside:between` outside all but the
    request's), each idle gap cut at both kinds of edges, largest
    first."""
    program, bench = Spans(stages.spans), Spans(trace.spans)
    edges = sorted({t for _, a, b in stages.spans + trace.spans
                    for t in (a, b)})
    by: Dict[str, float] = {}
    for a, b in gaps([(op.start, op.end) for op in trace.ops],
                     trace.window()):
        cuts = edges[bisect.bisect_right(edges, a):
                     bisect.bisect_left(edges, b)]
        for lo, hi in zip([a] + cuts, cuts + [b]):
            mid = (lo + hi) / 2
            name = program.innermost(mid)
            if name is None:
                span = bench.innermost(mid)
                name = "outside:" + (span if span not in (None, "request")
                                     else "between")
            by[name] = by.get(name, 0.0) + (hi - lo)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def readings(trace: trace_mod.Trace, stages: trace_mod.Trace, per: str,
             units: int) -> Dict[str, Optional[float]]:
    """The five stage readings of a cell whose requests are counted in
    `per` ("images" or "pairs"; `units` of them in the window), under
    the names a per-layer metric would give them; None where the trace
    holds no such range."""
    window = trace.window()
    out = {f"backbone_device_ms.{per}":
           stage_device_ms(stages, "extract.backbone", units)}
    if per == "pairs":
        out.update({
            "assignment_device_ms.pairs":
                stage_device_ms(stages, "lighterglue.assign", units),
            "matcher_host_ms.pairs":
                stage_host_ms(stages, MATCHER, window, units),
            "matcher_idle.pairs":
                stage_idle_pct(trace.ops, stages, MATCHER, window)})
    return out


def measure(cell_name: str, seed: int, seconds: float, device="cuda",
            root: Path = ROOT, overrides: Optional[Dict] = None
            ) -> Dict:
    """Set-up and warm-up of `cell_name` as a run makes them, then one
    traced window of `seconds` (at least one pass over the distinct
    requests) -> the readings of the window. `overrides` as
    `harness.run_cell` takes them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from xfeat_bench import harness
    from xfeat_bench.readers import idle_pct, launches_per_request

    c = harness.open_cell(cell_name, root, overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    prog = c.pipeline.Program(c.config, root, dev)
    requests = c.pipeline.make_requests(c.traffic, c.config, c.views, seed,
                                        dev, root)
    tracer = trace_mod.Tracer()
    execute = c.pipeline.Executor(prog, c.config, c.traffic, dev, tracer,
                                  c.views.hw)
    with torch.inference_mode():
        for req in requests:
            execute(req)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    done = []
    with profile(activities=acts) as prof:
        tracer.on = True
        t0 = time.perf_counter()
        with torch.inference_mode():
            while len(done) < len(requests) \
                    or time.perf_counter() - t0 < seconds:
                req = requests[len(done) % len(requests)]
                execute(req)
                done.append(req)
        tracer.on = False
    trace = trace_mod.read_profile(prof)
    stages = read_stages(prof)
    del prof
    per = "images" if c.traffic["request"] == "images" else "pairs"
    units = sum(getattr(r, per) for r in done)
    window = trace.window()
    run = harness.Traced(trace, window, done)
    by_stage: Dict[str, float] = {}
    for op in stages.ops:
        if op.span:
            by_stage[op.span] = by_stage.get(op.span, 0.0) + op.end - op.start
    return {
        "workload": cell_name, "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "setup_s": setup_s, "requests": len(done), per: units,
        "window_s": window[1] - window[0],
        "requests_per_s": len(done) / (window[1] - window[0]),
        "idle_pct": idle_pct(run),
        "launches": launches_per_request(run),
        "readings": readings(trace, stages, per, units),
        "stage_device_ms": {k: 1e3 * v / units
                            for k, v in sorted(by_stage.items())},
        "idle_stages": idle_stages(trace, stages),
        "idle_gaps": trace_mod.breakdown(trace)["idle_gaps"],
        "stage_ranges_per_request": len(stages.spans) / len(done),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = json.dumps(measure(args.workload, args.seed, args.seconds))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
