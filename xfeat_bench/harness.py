"""One run of one cell: set-up, warm-up, the measured window, the traced
reading, and the comparison that decides `correct`.

What a cell runs is its configuration's pipeline, `pipelines/<name>.py`,
found by the name the configuration gives (`xfeat` where it gives none;
`pipelines/xfeat.py` says what a pipeline provides): its request kinds,
the program's entries, the control, and the check with its own limits.
This module holds what every pipeline shares.

A request starts with its inputs in page-locked host memory and ends when
its outputs are in page-locked host memory: the upload, the calls into
the program and the readback, copied by DMA. (Pageable buffers, as the
port's `eval/batched` uses, made the copies the host's memcpy: 2.7x
slower and 9-24% apart from run to run on the card's host.) One
client sends requests back to back (a closed loop), cycling through a
small fixed set of distinct requests made in set-up from the seed.
"""

from __future__ import annotations

import copy
import gc
import sys
import time
import traceback
from dataclasses import dataclass
from functools import cached_property
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, inputs, spec as spec_mod
from .timeline import percentile
from .trace import Trace, Tracer, breakdown, read_profile

TRACE_MAX_SECONDS = 10.0    # the traced run's window, at most


@dataclass
class Traced:
    """What a per-layer metric's reader gets: the trace, its window, and
    the work of each request inside the window, in order."""
    trace: Trace
    window: Tuple[float, float]
    work: List[Dict[str, Any]]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _deep_update(base: Dict, changes: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in changes.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


@dataclass
class Cell:
    """A cell's entry, configuration, traffic mix and pipeline, and its
    views, decoded at their first use (after the program has loaded, as
    a run always did)."""
    spec: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    pipeline: ModuleType
    root: Path
    crop_hw: Optional[Tuple[int, int]]

    @cached_property
    def views(self) -> inputs.Views:
        return inputs.Views(Path(self.root) / self.traffic["views"],
                            self.traffic["pairs_file"], self.crop_hw)


def open_cell(cell_name: str, root: Path = spec_mod.ROOT,
              overrides: Optional[Dict] = None) -> Cell:
    """`overrides` changes the traffic, the configuration or the views
    (`{"traffic": {...}, "config": {...}, "crop_hw": (h, w)}`): tests run
    tiny cells on the CPU with it."""
    overrides = overrides or {}
    spec = spec_mod.load(root)
    cell = spec_mod.cell(spec, cell_name)
    config = _deep_update(spec_mod.config(spec, cell["config"], root),
                          overrides.get("config", {}))
    traffic = _deep_update(spec_mod.traffic(cell["traffic"], root),
                           overrides.get("traffic", {}))
    pipe = spec_mod.pipeline(config.get("pipeline",
                                        spec_mod.DEFAULT_PIPELINE), root)
    return Cell(spec, config, traffic, pipe, root, overrides.get("crop_hw"))


def _to_host(extras: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in extras.items()}


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: Path = spec_mod.ROOT, overrides: Optional[Dict] = None,
             program: str = "Program") -> Dict[str, Any]:
    """One run of `cell_name`; returns the result's JSON object.
    `overrides` as `open_cell` takes them. `program` names the pipeline's
    class in the program's place: `Program` or `Control`."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = open_cell(cell_name, root, overrides)
    spec, config, traffic, pipe = c.spec, c.config, c.traffic, c.pipeline
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    prog = getattr(pipe, program)(config, root, dev)
    requests = pipe.make_requests(traffic, config, c.views, seed, dev, root)
    n_req = len(requests)
    tracer = Tracer(on=False)
    execute = pipe.Executor(prog, config, traffic, dev, tracer, c.views.hw)

    # warm-up: every distinct request once, in the window's order
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for req in requests:
            execute(req)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s ({n_req} distinct requests)")

    # the measured window
    window_seconds = min(seconds, TRACE_MAX_SECONDS) if trace else seconds
    rng = np.random.default_rng(seed)
    seen = [0] * n_req
    sampled: List[Any] = [None] * n_req
    walls: List[float] = []
    order: List[int] = []
    failed = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        tracer.on = True
    tracer.host.clear()
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    with torch.inference_mode():
        while i < n_req or time.perf_counter() - t0 < window_seconds:
            r = i % n_req
            ts = time.perf_counter()
            try:
                result = execute(requests[r])
            except RuntimeError:
                failed += 1
                traceback.print_exc(file=sys.stderr)
                result = None
            t_end = time.perf_counter()
            walls.append(t_end - ts)
            order.append(r)
            if result is not None:
                seen[r] += 1
                if rng.random() * seen[r] < 1.0:   # a uniform sample
                    sampled[r] = result
            i += 1
    if prof is not None:
        tracer.on = False
        prof.__exit__(None, None, None)
    window_s = t_end - t0
    attempted = len(walls)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    traced = None
    if prof is not None:
        traced = read_profile(prof)
        del prof
        _log(f"trace: {len(traced.ops)} device operations, "
             f"{traced.unattributed} not tied to a span")

    # the check, after the program's state is freed
    answers = []
    for s in sampled:
        if s is None:
            answers.append(None)
            continue
        out, extras = s
        out = dict(out)
        out.update(_to_host(extras))
        answers.append(out)
    del sampled, execute, prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if any(a is None for a in answers):
        numbers, work, correct = {}, [], False
        shown = {}
    else:
        numbers, work = pipe.judge(config, traffic, requests, answers,
                                   root, dev)
        correct, shown = check.verdict(numbers, pipe.LIMITS)
    correct = correct and failed == 0

    images = sum(requests[r].images for r in order)
    pairs = sum(requests[r].pairs for r in order)
    _log(f"window {window_s:.3f} s: {attempted} requests, {failed} failed, "
         f"{images} images, {pairs} pairs")
    _log("host ms a request, median (quartiles): " + ", ".join(
        f"{k} {percentile(v, 50) * 1e3:.3f} ({percentile(v, 25) * 1e3:.3f}-"
        f"{percentile(v, 75) * 1e3:.3f})"
        for k, v in tracer.host.items() if len(v) >= attempted))
    result: Dict[str, Any] = {"correct": bool(correct),
                              "attempted": attempted, "failed": failed}
    if not trace:
        values = {"images_per_s": images / window_s,
                  "pairs_per_s": pairs / window_s,
                  "request_ms_p95": percentile(walls, 95) * 1e3,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec_mod.end_to_end(spec, cell_name)}
    else:
        run = Traced(traced, traced.window(), [work[r] for r in order]
                     if work else [])
        metrics = {}
        for m in spec_mod.per_layer(spec, cell_name):
            value = spec_mod.metric_reader(m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    result["device"] = device_info(dev, memory_peak)
    if traced is not None:
        from .readers import busy_s
        result["device"]["busy_s"] = busy_s(traced)
        result["device"]["window_s"] = traced.window()[1] - \
            traced.window()[0]
        result["breakdown"] = breakdown(traced)
    result["checks"] = shown
    return result


def device_info(dev: torch.device, memory_peak: int) -> Dict[str, Any]:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
