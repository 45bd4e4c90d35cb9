"""LightGlue at its published widths on the port's LighterGlue path: the
`xfeat` pipeline's request kinds, executor and extraction, then
`lighterglue_forward` with the configuration's heads, width confidence
and depth confidence, judged against `reference/lightglue.py`.

- `Program`: `xfeat`'s, its matcher call passing `num_heads`,
  `depth_confidence` and the width gate of `prune_width`; it also reads
  back `layers`, the layers each pair ran.
- `Control`: the LightGlue reference at TF32 in the program's place.
- `judge`: the extraction as `xfeat` judges it; per pair the reference on
  the program's own keypoints and descriptors, its exit and pruning
  decisions turned the program's way where they differ (the margin of
  each turned decision counts), then the matches against the reference's
  log assignment of the program's exit layer (`lightglue_gap`, in logits
  and log-probabilities) and the log scores of the matches both give
  (`lightglue_log_mscore_gap`). Each request's `work`: the backbone's and
  the matcher's operations and kernel D's launches over the points the
  reference keeps up to its exit layer, and `layers`, the program's
  layers summed over the pairs.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from xfeat_bench import check, counts, program, spec
from xfeat_bench.reference import lightglue as ref_lg
from xfeat_bench.reference import weights as ref_weights

_xfeat = spec.pipeline("xfeat", Path(__file__).resolve().parents[2])
make_requests, Executor = _xfeat.make_requests, _xfeat.Executor
Tensors = Dict[str, torch.Tensor]
MATCH_KEYS = ("matches0", "mscores0", "keep0", "keep1", "layers")

# Between the program's widest reading over 12 seeds and the TF32
# control's narrowest over 3, at the cell's size (`readings.py` on the
# card; PERF.md gives both).
LIMITS = {
    "lightglue_gap": 1e-3,              # lower 1.67e-4, upper 4.30e-3
    "lightglue_log_mscore_gap": 2e-3,   # lower 6.31e-4, upper 9.28e-3
}


class Program(_xfeat.Program):
    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        from accelerated_features_tpu_torch.models import lighterglue
        conf = self.config["lighterglue"]
        out = lighterglue.lighterglue_forward(
            self.lg, f0["keypoints"], f1["keypoints"], f0["descriptors"],
            f1["descriptors"], size, size, f0["valid"], f1["valid"],
            heads=conf["num_heads"],
            width_confidence=_xfeat.prune_width(conf, f0["valid"],
                                                f1["valid"]),
            pruning_min_kpts=0, depth_confidence=conf["depth_confidence"])
        return {k: out[k] for k in MATCH_KEYS}


class Control(_xfeat.Control):
    """The LightGlue reference at TF32, a pair at a time."""

    def __init__(self, config: Dict[str, Any], root: Path, device):
        self.config, self.device = config, torch.device(device)
        self.params = ref_weights.load_xfeat(
            program.weight_path(config["weights"]["extractor"], root),
            self.device)
        self.lg = ref_lg.weights(config["weights"]["matcher"],
                                 config["lighterglue"], self.device)

    def lighterglue(self, f0: Tensors, f1: Tensors,
                    size: torch.Tensor) -> Tensors:
        conf = self.config["lighterglue"]
        b, k = f0["valid"].shape
        dev = self.device
        out = {"matches0": torch.full((b, k), -1, dtype=torch.int64,
                                      device=dev),
               "mscores0": torch.zeros((b, k), device=dev),
               "keep0": torch.zeros((b, k), dtype=torch.bool, device=dev),
               "keep1": torch.zeros((b, k), dtype=torch.bool, device=dev),
               "layers": torch.zeros((b,), dtype=torch.int64, device=dev)}
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
            out["layers"][i] = r["layers"]
        return out


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------

def _turn_exit(r: Dict[str, Any], layers: int, force_exit: Dict[int, bool]
               ) -> float:
    """Where the program ran `layers` layers and the reference another
    number, the exit decision the reference has to take the other way, in
    `force_exit`; -> its margin."""
    at, stop = (layers - 1, True) if layers < r["layers"] \
        else (r["layers"] - 1, False)
    taken = [mg for i, _, mg in r["exits"] if i == at]
    if not taken or at in force_exit:
        return check.IMPOSSIBLE
    force_exit[at] = stop
    return min(taken[0], check.IMPOSSIBLE)


@torch.no_grad()
def judge_pair(params: Dict[str, Any], conf: Dict[str, Any],
               feats0: Tensors, feats1: Tensors, size: torch.Tensor,
               got: Tensors) -> Dict[str, Any]:
    """One pair: the program's extraction answers for both images (K
    slots each) and its matcher answers. -> the two gaps, and the
    reference's run as the program's decisions turned it (for the work)."""
    s0 = torch.nonzero(feats0["valid"])[:, 0]
    s1 = torch.nonzero(feats1["valid"])[:, 0]
    k = feats0["valid"].numel()
    dev = s0.device
    layers = int(got["layers"])
    pk = [got["keep0"][s0], got["keep1"][s1]]
    force: Dict = {}
    force_exit: Dict[int, bool] = {}
    margins: List[float] = []
    bad = not 1 <= layers <= conf["n_layers"]
    for _ in range(conf["n_layers"] + 6):
        r = ref_lg.forward_pair(params, conf, feats0["keypoints"][s0],
                                feats1["keypoints"][s1],
                                feats0["descriptors"][s0],
                                feats1["descriptors"][s1], size, size,
                                "full", force, force_exit)
        if bad:
            break
        if r["layers"] != layers:
            margins.append(_turn_exit(r, layers, force_exit))
            if margins[-1] >= check.IMPOSSIBLE:
                break
            continue
        before = len(force)
        for side in (0, 1):
            margins += check._force_from(r["decisions"][side], pk[side],
                                         r["ind"][side], force, side)
        if len(force) == before:
            break
    gap = check.IMPOSSIBLE if bad or r["layers"] != layers \
        else max(margins, default=0.0)
    impossible = {"lightglue_gap": check.IMPOSSIBLE,
                  "lightglue_log_mscore_gap": check.IMPOSSIBLE, "run": r}

    # the program's matches of valid rows, in the reference's indices
    m0 = got["matches0"]
    if bool(((m0 >= 0) & ~feats0["valid"]).any()):
        return impossible
    slot_to_ref1 = torch.full((k,), -1, dtype=torch.int64, device=dev)
    slot_to_ref1[s1] = torch.arange(s1.numel(), device=dev)
    claim_ref = torch.where(m0[s0] >= 0, slot_to_ref1[m0[s0].clamp(min=0)],
                            torch.full_like(m0[s0], -2))
    ind0, ind1 = r["ind"]
    m, n = ind0.numel(), ind1.numel()
    kept_pos1 = torch.full((s1.numel() + 1,), -1, dtype=torch.int64,
                           device=dev)
    kept_pos1[ind1] = torch.arange(n, device=dev)
    claim = claim_ref[ind0]
    matched = claim != -2
    col = torch.where(claim >= 0, kept_pos1[claim.clamp(min=0)], claim)
    pruned_rows = torch.ones(s0.numel(), dtype=torch.bool, device=dev)
    pruned_rows[ind0] = False
    if bool((matched & (col < 0)).any()) \
            or bool((pruned_rows & (claim_ref != -2)).any()):
        return impossible
    log_gap = 0.0
    if m and n:
        inner = r["scores"][:m, :n]
        gap = max(gap, check._max(check._assignment_gaps(
            inner[None], col[None], matched[None])))
        both = (r["matches0"][ind0] >= 0) & matched & \
            (r["matches0"][ind0] == claim)
        rows = torch.nonzero(both)[:, 0]
        ref_log = inner[rows, col[rows]]
        got_log = torch.log(got["mscores0"][s0][ind0][rows])
        log_gap = check._max(torch.nan_to_num(
            (got_log - ref_log).abs(), nan=check.IMPOSSIBLE,
            posinf=check.IMPOSSIBLE))
    return {"lightglue_gap": gap, "lightglue_log_mscore_gap": log_gap,
            "run": r}


def pair_work(conf: Dict[str, Any], r: Dict[str, Any]) -> float:
    """The matcher's operations on one pair up to its exit layer: the
    layers, attention and assignment (`counts.lighterglue_flops`), and the
    token-confidence heads of the exit decisions taken."""
    d = conf["descriptor_dim"]
    pruned = [(any(x[0] == i for x in r["decisions"][0]),
               any(x[0] == i for x in r["decisions"][1]))
              for i in range(len(r["counts"]))]
    flops = counts.lighterglue_flops(conf, r["counts"], pruned)
    for i, _, _ in r["exits"]:
        flops += 2.0 * d * sum(r["counts"][i])
    return flops


def judge(config: Dict, traffic: Dict, requests: List, answers: List,
          root: Path, device) -> Tuple[Dict[str, float], List[Dict]]:
    """The compared numbers over every distinct request's sampled answer,
    and each distinct request's work (for the metrics)."""
    dev = torch.device(device)
    ex, conf = config["extractor"], config["lighterglue"]
    top_k, d = traffic["top_k"], conf["descriptor_dim"]
    params = ref_weights.load_xfeat(
        program.weight_path(config["weights"]["extractor"], root), dev)
    lg = ref_lg.weights(config["weights"]["matcher"], conf, dev)
    parts, work = [], []
    for req, got in zip(requests, answers):
        imgs = req.arrays["images"].numpy()
        h, wd = imgs.shape[1:3]
        hc, wc = h // 32 * 32, wd // 32 * 32
        parts.append(check.judge_extraction(
            params, imgs, {k: got[k] for k in _xfeat.EXTRACT_KEYS}, top_k,
            ex["detection_threshold"], dev))
        w: Dict[str, Any] = {
            "images": req.images, "pairs": req.pairs,
            "flops": counts.xfeat_flops(hc, wc) * req.images,
            "detect_bytes": counts.detect_bytes(hc, wc, top_k) * req.images,
            "layers": int(got["layers"].sum())}
        p = req.pairs
        size = torch.tensor([wd, h], dtype=torch.float32, device=dev)
        launches = []
        for i in range(p):
            def feats(j):
                return {key: torch.as_tensor(got[key][j], device=dev)
                        for key in ("keypoints", "descriptors", "valid")}
            r = judge_pair(lg, conf, feats(i), feats(p + i), size,
                           {key: torch.as_tensor(got[key][i], device=dev)
                            for key in MATCH_KEYS})
            parts.append({key: r[key] for key in LIMITS})
            w["flops"] += pair_work(conf, r["run"])
            launches.append(counts.attention_launches(r["run"]["counts"]))
        # one launch of kernel D serves every pair of the batch; a pair
        # that stopped adds no work to the launches after its exit
        w["attention"] = [
            (sum(counts.attention_flops(q, k, d) for q, k in launch),
             sum(counts.attention_bytes(q, k, d) for q, k in launch))
            for launch in itertools.zip_longest(*launches, fillvalue=(0, 0))]
        work.append(w)
    return check.merge(parts), work

