"""One run of one cell: set-up, warm-up, the measured window, the traced
reading, and the comparison that decides `correct`.

A request starts with its inputs in page-locked host memory and ends when
its outputs are in page-locked host memory: the upload, the calls into
the program and the readback, copied by DMA. (Pageable buffers, as the
port's `eval/batched` uses, made the copies the host's memcpy: 2.7x
slower and 9-24% apart from run to run on the card's host.) One
client sends requests back to back (a closed loop), cycling through a
small fixed set of distinct requests made in set-up from the seed.

Request kinds, named by the traffic mix:
- `images`: a batch of views -> keypoints, scores, descriptors, valid.
- `pairs`: the views of a batch of pairs, extracted in one call, then the
  configuration's matcher over the pairs -> the matches, and the keypoints
  and valid masks they index.
- `feature_block`: the features of a block of views (made in set-up by
  the reference extractor) -> every pair of the block matched, a chunk of
  pairs at a time.
"""

from __future__ import annotations

import copy
import gc
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, counts, inputs, spec as spec_mod
from .program import Program
from .reference import weights as ref_weights
from .reference import xfeat as ref_xfeat
from .timeline import percentile
from .trace import Trace, Tracer, breakdown, read_profile

TRACE_MAX_SECONDS = 10.0    # the traced run's window, at most


@dataclass
class Request:
    arrays: Dict[str, torch.Tensor]     # host memory
    images: int
    pairs: int
    block_pairs: List[Tuple[int, int]] = field(default_factory=list)


def host_tensor(a: np.ndarray, pinned: bool) -> torch.Tensor:
    """A host copy of `a`: page-locked when `pinned` (with a card), else
    numpy's own memory."""
    if not pinned:
        return torch.from_numpy(np.ascontiguousarray(a))
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                    pin_memory=True)
    t.numpy()[...] = a
    return t


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


# --------------------------------------------------------------------------
# set-up: the requests
# --------------------------------------------------------------------------

def make_requests(traffic: Dict, config: Dict, views: inputs.Views,
                  seed: int, device, root: Path) -> List[Request]:
    rng = np.random.default_rng(seed)
    kind, n = traffic["request"], traffic["distinct_requests"]
    hom = traffic["homography"]
    pinned = torch.device(device).type == "cuda"

    def host(arrays):
        return {k: host_tensor(a, pinned) for k, a in arrays.items()}

    if kind == "images":
        b = traffic["views_per_request"]
        idx = inputs.draw(rng, len(views.images), b * n)
        imgs = inputs.warped_views(views, idx, rng, hom, device)
        return [Request(host({"images": imgs[r * b:(r + 1) * b]}), b, 0)
                for r in range(n)]
    if kind == "pairs":
        p = traffic["pairs_per_request"]
        chosen = inputs.draw(rng, len(views.pairs), p * n)
        out = []
        for r in range(n):
            sel = [views.pairs[i] for i in chosen[r * p:(r + 1) * p]]
            idx = [a for a, _ in sel] + [b for _, b in sel]
            out.append(Request(host({"images": inputs.warped_views(
                views, idx, rng, hom, device)}), 2 * p, p))
        return out
    if kind == "feature_block":
        v = traffic["views_per_block"]
        ex = config["extractor"]
        params = ref_weights.load_xfeat(str(root / config["weights"]
                                            ["extractor"]), device)
        pairs = inputs.pair_blocks(v)
        out = []
        for r in range(n):
            idx = inputs.draw(rng, len(views.images), v)
            imgs = inputs.warped_views(views, idx, rng, hom, device)
            feats = {"keypoints": [], "descriptors": [], "valid": []}
            for c0 in range(0, v, 10):
                f = ref_xfeat.extract(
                    params, torch.from_numpy(imgs[c0:c0 + 10]).to(device),
                    traffic["top_k"], ex["detection_threshold"])
                for k in feats:
                    feats[k].append(f[k].cpu().numpy())
            out.append(Request(host({k: np.concatenate(a)
                                     for k, a in feats.items()}),
                               0, len(pairs), pairs))
        del params
        return out
    raise ValueError(f"unknown request kind {kind!r}")


# --------------------------------------------------------------------------
# the timed path
# --------------------------------------------------------------------------

EXTRACT_KEYS = ("keypoints", "scores", "descriptors", "valid")


class Executor:
    """Runs one request through the program; returns the outputs read
    back to host memory and the device tensors the check reads after the
    window."""

    def __init__(self, prog, config: Dict, traffic: Dict, device,
                 tracer: Tracer, hw: Tuple[int, int]):
        self.prog, self.config, self.traffic = prog, config, traffic
        self.device, self.tracer = torch.device(device), tracer
        self.kind = traffic["request"]
        self.matcher = config.get("matcher")
        self.pinned = self.device.type == "cuda"
        self._chunk_index = None
        if self.kind == "pairs" and self.matcher == "lighterglue":
            p = traffic["pairs_per_request"]
            self.size = torch.tensor([[hw[1], hw[0]]] * p,
                                     dtype=torch.float32, device=self.device)

    def __call__(self, req: Request):
        span = self.tracer.span
        top_k = self.traffic["top_k"]
        with span("request"):
            if self.kind == "images":
                with span("upload"):
                    x = self._up(req.arrays["images"])
                with span("extract"):
                    f = self.prog.extract(x, top_k)
                with span("readback"):
                    out = {k: self._down(f[k]) for k in EXTRACT_KEYS}
                return out, {}
            if self.kind == "pairs":
                p = req.pairs
                with span("upload"):
                    x = self._up(req.arrays["images"])
                with span("extract"):
                    f = self.prog.extract(x, top_k)
                f0 = {k: v[:p] for k, v in f.items()}
                f1 = {k: v[p:] for k, v in f.items()}
                with span("match"):
                    m = self._match(f0, f1)
                with span("readback"):
                    out = {k: self._down(v) for k, v in m.items()}
                    out["keypoints"] = self._down(f["keypoints"])
                    out["valid"] = self._down(f["valid"])
                return out, {"scores": f["scores"],
                             "descriptors": f["descriptors"]}
            if self.kind == "feature_block":
                with span("upload"):
                    d = self._up(req.arrays["descriptors"])
                    v = self._up(req.arrays["valid"])
                    k = self._up(req.arrays["keypoints"])
                n = len(req.block_pairs)
                out: Dict[str, torch.Tensor] = {}
                for c0, c1, a, b in self._chunks(req.block_pairs):
                    with span("match"):
                        m = self._match(
                            {"descriptors": d[a], "valid": v[a],
                             "keypoints": k[a]},
                            {"descriptors": d[b], "valid": v[b],
                             "keypoints": k[b]})
                    with span("readback"):
                        for key, t in m.items():
                            if key not in out:
                                out[key] = self._host((n,) + t.shape[1:],
                                                      t.dtype)
                            out[key][c0:c1].copy_(t)
                return {key: t.numpy() for key, t in out.items()}, {}
        raise ValueError(f"unknown request kind {self.kind!r}")

    def _chunks(self, pairs: List[Tuple[int, int]]):
        """(start, end, rows of the first views, rows of the second) of
        each chunk of a block's pairs, the index tensors on the device,
        made once (every block has the same pairs)."""
        if self._chunk_index is None:
            step = self.traffic["pairs_per_chunk"]
            self._chunk_index = []
            for c0 in range(0, len(pairs), step):
                sel = pairs[c0:c0 + step]
                self._chunk_index.append((
                    c0, c0 + len(sel),
                    torch.tensor([q[0] for q in sel], device=self.device),
                    torch.tensor([q[1] for q in sel], device=self.device)))
        return self._chunk_index

    def _up(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def _host(self, shape, dtype) -> torch.Tensor:
        """An empty host tensor of the traffic's kind of memory."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.pinned)

    def _down(self, t: torch.Tensor) -> np.ndarray:
        """Device -> host memory of the traffic's kind; waits for it."""
        out = self._host(t.shape, t.dtype)
        out.copy_(t)
        return out.numpy()

    def _match(self, f0, f1) -> Dict[str, torch.Tensor]:
        if self.matcher == "mnn":
            idx1, mask = self.prog.mnn(f0["descriptors"], f1["descriptors"],
                                       f0["valid"], f1["valid"])
            return {"idx1": idx1, "mask": mask}
        if self.matcher == "lighterglue":
            size = self.size[:f0["valid"].shape[0]]
            return self.prog.lighterglue(f0, f1, size)
        raise ValueError(f"unknown matcher {self.matcher!r}")


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def _to_host(extras: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in extras.items()}


def judge(config: Dict, traffic: Dict, requests: List[Request],
          answers: List[Dict[str, np.ndarray]], root: Path, device
          ) -> Tuple[Dict[str, float], List[Dict[str, Any]]]:
    """The compared numbers over every distinct request's sampled answer,
    and each distinct request's work (for the metrics)."""
    dev = torch.device(device)
    ex = config["extractor"]
    top_k = traffic["top_k"]
    kind = traffic["request"]
    params = ref_weights.load_xfeat(str(root / config["weights"]
                                        ["extractor"]), dev)
    lg = None
    if config.get("matcher") == "lighterglue":
        lg = ref_weights.load_lighterglue(str(root / config["weights"]
                                              ["matcher"]), dev)
    parts, work = [], []
    for req, got in zip(requests, answers):
        w: Dict[str, Any] = {"images": req.images, "pairs": req.pairs}
        if kind in ("images", "pairs"):
            imgs = req.arrays["images"].numpy()
            h, wd = imgs.shape[1:3]
            parts.append(check.judge_extraction(
                params, imgs, {k: got[k] for k in EXTRACT_KEYS}, top_k,
                ex["detection_threshold"], dev))
            w["flops"] = counts.xfeat_flops(h // 32 * 32, wd // 32 * 32) \
                * req.images
            w["detect_bytes"] = counts.detect_bytes(
                h // 32 * 32, wd // 32 * 32, top_k) * req.images
        else:
            w["flops"] = 0.0
        if kind == "pairs" and config["matcher"] == "lighterglue":
            p = req.pairs
            h, wd = req.arrays["images"].shape[1:3]
            size = torch.tensor([wd, h], dtype=torch.float32, device=dev)
            conf = config["lighterglue"]
            attn = []
            for i in range(p):
                def feats(j):
                    return {k: torch.as_tensor(got[k][j], device=dev)
                            for k in ("keypoints", "descriptors", "valid")}
                r = check.judge_lighterglue_pair(
                    lg, conf, feats(i), feats(p + i), size,
                    {k: torch.as_tensor(got[k][i], device=dev)
                     for k in ("matches0", "mscores0", "keep0", "keep1")})
                parts.append({k: r[k] for k in ("matcher_gap",
                                                "mscore_gap")})
                pruned = [(any(d[0] == li for d in r["decisions"][0]),
                           any(d[0] == li for d in r["decisions"][1]))
                          for li in range(len(r["counts"]))]
                w["flops"] += counts.lighterglue_flops(conf, r["counts"],
                                                       pruned)
                attn.append(counts.attention_launches(r["counts"]))
            # one launch of kernel D serves every pair of the batch
            d = conf["descriptor_dim"]
            w["attention"] = [
                (sum(counts.attention_flops(q, k, d) for q, k in launch),
                 sum(counts.attention_bytes(q, k, d) for q, k in launch))
                for launch in zip(*attn)]
        if kind in ("pairs", "feature_block") and config["matcher"] == "mnn":
            if kind == "feature_block":
                descs = req.arrays["descriptors"].to(dev)
                valid = req.arrays["valid"].to(dev)
                pairs = req.block_pairs
            else:
                p = req.pairs
                descs = torch.as_tensor(got["descriptors"], device=dev)
                valid = torch.as_tensor(got["valid"], device=dev)
                pairs = [(i, p + i) for i in range(p)]
            parts.append(check.judge_mnn(descs, valid, pairs, got["idx1"],
                                         got["mask"]))
            n = valid.sum(1).tolist()
            k = valid.shape[1]
            w["mnn_flops"] = sum(counts.mnn_flops(n[a], n[b])
                                 for a, b in pairs)
            w["mnn_bytes"] = sum(counts.mnn_bytes(k, k) for _ in pairs)
            w["flops"] += w["mnn_flops"]
        work.append(w)
    return check.merge(parts), work


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             root: Path = spec_mod.ROOT, overrides: Optional[Dict] = None,
             program: Callable = Program) -> Dict[str, Any]:
    """One run of `cell_name`; returns the result's JSON object.
    `overrides` changes the traffic, the configuration or the views
    (`{"traffic": {...}, "config": {...}, "crop_hw": (h, w)}`): tests run
    tiny cells on the CPU with it. `program` is `Program` or `Control`."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    spec = spec_mod.load(root)
    cell = spec_mod.cell(spec, cell_name)
    config = _deep_update(spec_mod.config(spec, cell["config"], root),
                          overrides.get("config", {}))
    traffic = _deep_update(spec_mod.traffic(cell["traffic"], root),
                           overrides.get("traffic", {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    prog = program(config, root, dev)
    views = inputs.Views(root / traffic["views"], traffic["pairs_file"],
                         overrides.get("crop_hw"))
    requests = make_requests(traffic, config, views, seed, dev, root)
    n_req = len(requests)
    tracer = Tracer(on=False)
    execute = Executor(prog, config, traffic, dev, tracer, views.hw)

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
        numbers, work = judge(config, traffic, requests, answers, root, dev)
        correct, shown = check.verdict(numbers)
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
