"""XFeat's sparse extraction, then the configuration's matcher (`mnn` or
`lighterglue`): the pipeline of a configuration that names none.

A pipeline module gives the harness (`harness.run_cell`) six names:

- `make_requests(traffic, config, views, seed, device, root)`: the
  distinct requests of a run, made in set-up from the seed, each with
  `images` and `pairs` (what `images_per_s` and `pairs_per_s` count);
- `Executor(prog, config, traffic, device, tracer, hw)`: a callable that
  runs one request through `prog` inside the span `request` and returns
  (outputs read back to host memory, device tensors the check reads after
  the window);
- `Program(config, root, device)`: the port's entries (the port is
  imported only here and in `program.py`);
- `Control(config, root, device)`: the same calls answered by the plain
  reference at TF32, which the check has to find wrong;
- `judge(config, traffic, requests, answers, root, device)`: the numbers
  compared and each distinct request's `work` (what the metric readers
  read);
- `LIMITS`: the limit of each number `judge` returns that `check.LIMITS`
  does not hold.

Request kinds, named by the traffic mix:
- `images`: a batch of views -> keypoints, scores, descriptors, valid.
- `pairs`: the views of a batch of pairs, extracted in one call, then the
  configuration's matcher over the pairs -> the matches, and the keypoints
  and valid masks they index.
- `feature_block`: the features of a block of views (made in set-up by
  the reference extractor) -> every pair of the block matched, a chunk of
  pairs at a time.

`Program` drives the entries the port's batched evaluation drives:
`ops.extraction.detect_and_compute`,
`models.lighterglue.lighterglue_forward` and
`ops.cuda.mnn.batch_mnn_match_fused`. It reads the port's modules through
their attributes at every call, so a test can put a broken entry in their
place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from xfeat_bench import check, counts, inputs, program
from xfeat_bench.reference import lighterglue as ref_lg
from xfeat_bench.reference import mnn as ref_mnn
from xfeat_bench.reference import weights as ref_weights
from xfeat_bench.reference import xfeat as ref_xfeat
from xfeat_bench.trace import Tracer

Tensors = Dict[str, torch.Tensor]

# every number `judge` returns is one of `check.LIMITS`
LIMITS: Dict[str, float] = {}


@dataclass
class Request:
    arrays: Dict[str, torch.Tensor]     # host memory
    images: int
    pairs: int
    block_pairs: List[Tuple[int, int]] = field(default_factory=list)


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
        return {k: inputs.host_tensor(a, pinned) for k, a in arrays.items()}

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
        params = ref_weights.load_xfeat(
            program.weight_path(config["weights"]["extractor"], root),
            device)
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
# the program and its control
# --------------------------------------------------------------------------

def prune_width(conf: Dict[str, Any], valid0: torch.Tensor,
                valid1: torch.Tensor) -> float:
    """The width confidence a batched call runs with: on where the most
    valid points of any image exceed `pruning_min_kpts`, as the port's
    `LighterGlue.forward_padded` decides it on the real counts."""
    most = max(int(valid0.sum(1).max()), int(valid1.sum(1).max()))
    wc = conf["width_confidence"]
    return wc if wc > 0 and most > conf["pruning_min_kpts"] else -1.0


class Program:
    """The port, loaded from the configuration's weights. Its kernels
    build at their first call (in the warm-up), into the port's `_build/`
    inside the checkout."""

    def __init__(self, config: Dict[str, Any], root: Path, device):
        self.config, self.device = config, torch.device(device)
        w = config["weights"]
        self.params = program.xfeat_params(w["extractor"], root,
                                           self.device)
        self.lg = None
        if "matcher" in w:
            self.lg = program.lighterglue_params(
                w["matcher"], config["lighterglue"], root, self.device)

    def extract(self, images: torch.Tensor, top_k: int) -> Tensors:
        from accelerated_features_tpu_torch.ops import extraction
        ex = self.config["extractor"]
        return extraction.detect_and_compute(
            self.params, images, top_k, ex["detection_threshold"],
            torch.float32)

    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        from accelerated_features_tpu_torch.models import lighterglue
        conf = self.config["lighterglue"]
        out = lighterglue.lighterglue_forward(
            self.lg, f0["keypoints"], f1["keypoints"], f0["descriptors"],
            f1["descriptors"], size, size, f0["valid"], f1["valid"],
            heads=conf["num_heads"],
            width_confidence=prune_width(conf, f0["valid"], f1["valid"]),
            pruning_min_kpts=0)
        return {k: out[k] for k in ("matches0", "mscores0", "keep0",
                                    "keep1")}

    def mnn(self, d1, d2, v1, v2) -> Tuple[torch.Tensor, torch.Tensor]:
        from accelerated_features_tpu_torch.ops.cuda import mnn
        return mnn.batch_mnn_match_fused(d1, d2, v1, v2,
                                         self.config["mnn"]["min_cossim"])


class Control:
    """The reference in the program's place, at TF32."""

    precision = "tf32"

    def __init__(self, config: Dict[str, Any], root: Path, device):
        self.config, self.device = config, torch.device(device)
        w = config["weights"]
        self.params = ref_weights.load_xfeat(
            program.weight_path(w["extractor"], root), self.device)
        self.lg = None
        if "matcher" in w:
            self.lg = ref_weights.lighterglue(
                w["matcher"], config["lighterglue"], root, self.device)

    def extract(self, images: torch.Tensor, top_k: int) -> Tensors:
        ex = self.config["extractor"]
        return ref_xfeat.extract(self.params, images, top_k,
                                 ex["detection_threshold"], self.precision)

    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        conf = self.config["lighterglue"]
        b, k = f0["valid"].shape
        out = {"matches0": torch.full((b, k), -1, dtype=torch.int64,
                                      device=self.device),
               "mscores0": torch.zeros((b, k), device=self.device),
               "keep0": torch.zeros((b, k), dtype=torch.bool,
                                    device=self.device),
               "keep1": torch.zeros((b, k), dtype=torch.bool,
                                    device=self.device)}
        for i in range(b):
            s0 = torch.nonzero(f0["valid"][i])[:, 0]
            s1 = torch.nonzero(f1["valid"][i])[:, 0]
            r = ref_lg.forward_pair(
                self.lg, conf, f0["keypoints"][i][s0], f1["keypoints"][i][s1],
                f0["descriptors"][i][s0], f1["descriptors"][i][s1],
                size[i], size[i], self.precision)
            m = r["matches0"]
            out["matches0"][i, s0] = torch.where(m >= 0, s1[m.clamp(min=0)],
                                                 -1)
            out["mscores0"][i, s0] = r["mscores0"]
            out["keep0"][i, s0[r["ind"][0]]] = True
            out["keep1"][i, s1[r["ind"][1]]] = True
        return out

    def mnn(self, d1, d2, v1, v2) -> Tuple[torch.Tensor, torch.Tensor]:
        return ref_mnn.match(d1, d2, v1, v2,
                             self.config["mnn"]["min_cossim"],
                             self.precision)


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def judge(config: Dict, traffic: Dict, requests: List[Request],
          answers: List[Dict[str, np.ndarray]], root: Path, device
          ) -> Tuple[Dict[str, float], List[Dict[str, Any]]]:
    """The compared numbers over every distinct request's sampled answer,
    and each distinct request's work (for the metrics)."""
    dev = torch.device(device)
    ex = config["extractor"]
    top_k = traffic["top_k"]
    kind = traffic["request"]
    params = ref_weights.load_xfeat(
        program.weight_path(config["weights"]["extractor"], root), dev)
    lg = None
    if config.get("matcher") == "lighterglue":
        lg = ref_weights.lighterglue(config["weights"]["matcher"],
                                     config["lighterglue"], root, dev)
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
