"""The comparison that decides `correct`: the program's answers, as the
timed path produced them, against the plain reference
(`xfeat_bench/reference`, float32 with TF32 off).

Every number is the widest margin of the reference that an answer of the
program violates, or the widest gap between two values both sides give,
in the reference's own units:

- `select_gap` (heatmap and score units): a keypoint the program selected
  that the reference did not, by how far it fails the reference's
  selection (5x5 maximum, threshold, score > 0, rank within `top_k`); a
  keypoint the reference selected that the program dropped, by how far
  it passes it. Keypoints are compared by position.
- `score_gap`, `desc_gap`: over the keypoints both selected, the largest
  difference of score and of a descriptor component.
- `mnn_gap` (cosine similarity): a row the program matched, by how far
  its column lies below the best of its row or its column; a mutual match
  of the reference the program missed, by the smaller of the two top-2
  gaps that make it mutual.
- `matcher_gap` (logits and log-probabilities): LighterGlue's pruning
  decisions and matches, as for MNN on the reference's log assignment. The
  reference is run on the program's own keypoints and descriptors (the
  extraction's answers, judged by the numbers above), and where the
  program's final kept set differs from the reference's, the reference
  takes the program's decision at the layer where its own was closest,
  and the margin of that decision counts.
- `mscore_gap`: the largest difference of a match score both agree on.

An answer that no margin can explain (a duplicate keypoint, an index out
of range, a match to padding) reads `IMPOSSIBLE`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .reference import lighterglue as ref_lg
from .reference import xfeat as ref_xfeat
from .reference.precision import Products

IMPOSSIBLE = 1e6

# Each limit lies between the largest reading of sound runs of the program
# over a dozen seeds (the lower) and the smallest reading of the control
# (the upper), nearer the upper; the readings are in PERF.md. A pipeline
# (`pipelines/<name>.py`) adds the limits of numbers of its own.
LIMITS = {
    "select_gap": 1e-4,     # lower 1.48e-6, upper 1.92e-3
    "score_gap": 1e-3,      # lower 2.60e-5, upper 1.32e-2
    "desc_gap": 5e-4,       # lower 8.90e-6, upper 5.23e-3
    "mnn_gap": 2e-5,        # lower 4.77e-7, upper 1.83e-4
    "matcher_gap": 2e-3,    # lower 2.23e-4, upper 9.01e-3
    "mscore_gap": 5e-4,     # lower 6.82e-5, upper 1.68e-3
}


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _neighbour_max(heat: torch.Tensor) -> torch.Tensor:
    """(B,H,W) -> the largest value among each pixel's 24 neighbours of
    its 5x5 window (-inf outside the image)."""
    b, H, W = heat.shape
    pad = F.pad(heat, (2, 2, 2, 2), value=float("-inf"))
    out = torch.full_like(heat, float("-inf"))
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            out = torch.maximum(out, pad[:, dy:dy + H, dx:dx + W])
    return out


def _extraction_gaps(ref: Dict[str, torch.Tensor], got: Dict[str, Any],
                     threshold: float, top_k: int, rh: float, rw: float
                     ) -> Tuple[float, float, float]:
    kheat, dense = ref["kheat"], ref["dense"]
    b, H, W = kheat.shape
    nmax = _neighbour_max(kheat)
    cand = (kheat >= nmax) & (kheat > threshold)
    select = score = desc = 0.0
    dev = kheat.device
    for i in range(b):
        heat, s, nm = kheat[i].flatten(), dense[i].flatten(), nmax[i].flatten()
        n_cand = int(cand[i].sum())
        ranked = torch.sort(torch.where(cand[i].flatten(), s,
                                        torch.full_like(s, float("-inf"))),
                            descending=True, stable=True).values
        full = n_cand >= top_k
        s_k = ranked[top_k - 1] if full else None
        s_next = ranked[top_k] if n_cand > top_k else None

        rv = ref["valid"][i]
        rpos = ref["keypoints"][i][rv]
        rflat = (torch.round(rpos[:, 1] / rh) * W
                 + torch.round(rpos[:, 0] / rw)).long()
        pv = torch.as_tensor(got["valid"][i], device=dev)
        ppos = torch.as_tensor(got["keypoints"][i], device=dev)[pv]
        px, py = torch.round(ppos[:, 0] / rw), torch.round(ppos[:, 1] / rh)
        if ((px < 0) | (px >= W) | (py < 0) | (py >= H)).any():
            return IMPOSSIBLE, IMPOSSIBLE, IMPOSSIBLE
        pflat = (py * W + px).long()
        if torch.unique(pflat).numel() != pflat.numel():
            return IMPOSSIBLE, IMPOSSIBLE, IMPOSSIBLE

        extra = pflat[~torch.isin(pflat, rflat)]
        if extra.numel():
            v = torch.stack([(nm[extra] - heat[extra]).clamp(min=0),
                             (threshold - heat[extra]).clamp(min=0),
                             (-s[extra]).clamp(min=0)])
            if full:
                v = torch.cat([v, (s_k - s[extra]).clamp(min=0)[None]])
            select = max(select, _max(v.max(0).values))
        missed = rflat[~torch.isin(rflat, pflat)]
        if missed.numel():
            m = torch.stack([heat[missed] - nm[missed],
                             heat[missed] - threshold, s[missed]])
            if s_next is not None and torch.isfinite(s_next):
                m = torch.cat([m, (s[missed] - s_next)[None]])
            select = max(select, _max(m.min(0).values.clamp(min=0)))

        rsort, rorder = torch.sort(rflat)
        pin = torch.isin(pflat, rflat)
        at = torch.searchsorted(rsort, pflat[pin])
        ridx = rorder[at]
        pscores = torch.as_tensor(got["scores"][i], device=dev)[pv][pin]
        score = max(score, _max((pscores - ref["scores"][i][rv][ridx]).abs()))
        pdesc = torch.as_tensor(got["descriptors"][i], device=dev)[pv][pin]
        desc = max(desc, _max((pdesc - ref["descriptors"][i][rv][ridx])
                              .abs()))
    return select, score, desc


@torch.no_grad()
def judge_extraction(params: Dict[str, Any], images: np.ndarray,
                     got: Dict[str, np.ndarray], top_k: int,
                     threshold: float, device, chunk: int = 8
                     ) -> Dict[str, float]:
    """(N,H,W,3) uint8 images and the program's (N,K,...) answers."""
    out = {"select_gap": 0.0, "score_gap": 0.0, "desc_gap": 0.0}
    for c0 in range(0, len(images), chunk):
        x = torch.from_numpy(images[c0:c0 + chunk]).to(device)
        ref = ref_xfeat.extract(params, x, top_k, threshold, "full",
                                maps=True)
        _, rh, rw = ref_xfeat.to_unit(x[:1])
        part = {k: v[c0:c0 + chunk] for k, v in got.items()}
        gaps = _extraction_gaps(ref, part, threshold, top_k, rh, rw)
        for name, g in zip(("select_gap", "score_gap", "desc_gap"), gaps):
            out[name] = max(out[name], g)
    return out


def _top2(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """Best value, its index and the second best along `dim` (-inf when
    there is none)."""
    if x.shape[dim] < 2:
        best, idx = x.max(dim=dim)
        return best, idx, torch.full_like(best, float("-inf"))
    top = torch.topk(x, 2, dim=dim)
    return (top.values.select(dim, 0), top.indices.select(dim, 0),
            top.values.select(dim, 1))


def _assignment_gaps(sim: torch.Tensor, claim: torch.Tensor,
                     matched: torch.Tensor) -> torch.Tensor:
    """Mutual-argmax decisions on a (B,M,N) score table, padding -inf.
    `claim` (B,M) is the column the program matched each row to, `matched`
    (B,M) whether it matched. -> (B,M) margins violated."""
    rbest, ridx, rsecond = _top2(sim, 2)
    cbest, cidx, csecond = _top2(sim, 1)
    rows = torch.arange(sim.shape[1], device=sim.device)[None]
    ref_mutual = (torch.gather(cidx, 1, ridx) == rows) & torch.isfinite(rbest)
    n = sim.shape[2]
    ok = (claim >= 0) & (claim < n)
    j = claim.clamp(0, n - 1)
    s = torch.gather(sim, 2, j[..., None])[..., 0]
    bad = matched & (~ok | ~torch.isfinite(s))
    over = torch.maximum(rbest - s, torch.gather(cbest, 1, j) - s)
    gap = torch.where(matched, over, torch.zeros_like(over))
    miss = (~matched) & ref_mutual
    keep_margin = torch.minimum(rbest - rsecond,
                                torch.gather(cbest - csecond, 1, ridx))
    gap = torch.where(miss, keep_margin, gap)
    gap = torch.where(bad, torch.full_like(gap, IMPOSSIBLE), gap)
    return torch.nan_to_num(gap, nan=IMPOSSIBLE, posinf=IMPOSSIBLE)


@torch.no_grad()
def judge_mnn(descs: torch.Tensor, valid: torch.Tensor,
              pairs: Sequence[Tuple[int, int]], idx1: np.ndarray,
              mask: np.ndarray, chunk: int = 16) -> Dict[str, float]:
    """A block's features (N,K,64), (N,K) on the device, its pairs, and
    the program's (P,K) answers."""
    gap = 0.0
    prod = Products("full")
    for c0 in range(0, len(pairs), chunk):
        sel = pairs[c0:c0 + chunk]
        a = torch.tensor([p[0] for p in sel], device=descs.device)
        b = torch.tensor([p[1] for p in sel], device=descs.device)
        sim = prod.matmul(descs[a], descs[b].transpose(1, 2))
        keep = valid[a][:, :, None] & valid[b][:, None, :]
        sim = torch.where(keep, sim, torch.full_like(sim, float("-inf")))
        claim = torch.as_tensor(idx1[c0:c0 + chunk], device=descs.device)
        matched = torch.as_tensor(mask[c0:c0 + chunk], device=descs.device)
        g = _assignment_gaps(sim, claim, matched)
        g = torch.where(~valid[a] & matched, torch.full_like(g, IMPOSSIBLE), g)
        gap = max(gap, _max(g))
    return {"mnn_gap": gap}


def _force_from(decisions, port_keep: torch.Tensor, ind: torch.Tensor,
                force: Dict, side: int) -> List[float]:
    """Where the program's final kept set differs from the reference's,
    add the decision the reference has to take to `force`; -> margins."""
    n = port_keep.numel()
    ref_keep = torch.zeros(n, dtype=torch.bool, device=port_keep.device)
    ref_keep[ind] = True
    margins = []
    for p in torch.nonzero(port_keep != ref_keep)[:, 0].tolist():
        seen = [(abs(float(mg[pts == p][0])), layer, bool(kept[pts == p][0]))
                for layer, pts, mg, kept in decisions if (pts == p).any()]
        if port_keep[p]:
            pruned = [s for s in seen if not s[2]]
            if not pruned:
                margins.append(IMPOSSIBLE)
                continue
            m, layer, _ = pruned[0]
            force[(side, p, layer)] = True
        else:
            if not seen:
                margins.append(IMPOSSIBLE)
                continue
            m, layer, _ = min(seen)
            force[(side, p, layer)] = False
        margins.append(m)
    return margins


@torch.no_grad()
def judge_lighterglue_pair(params: Dict[str, Any], conf: Dict[str, Any],
                           feats0: Dict[str, torch.Tensor],
                           feats1: Dict[str, torch.Tensor],
                           size: torch.Tensor, got: Dict[str, torch.Tensor],
                           passes: int = 6) -> Dict[str, Any]:
    """One pair: the program's extraction answers for both images (K
    slots each) and its matcher answers. -> the two gaps, and the kept
    counts and pruning decisions the reference took (for the metrics)."""
    s0 = torch.nonzero(feats0["valid"])[:, 0]
    s1 = torch.nonzero(feats1["valid"])[:, 0]
    k = feats0["valid"].numel()
    pk = [got["keep0"][s0], got["keep1"][s1]]
    force: Dict = {}
    keep_margins: List[float] = []
    for _ in range(passes):
        r = ref_lg.forward_pair(params, conf, feats0["keypoints"][s0],
                                feats1["keypoints"][s1],
                                feats0["descriptors"][s0],
                                feats1["descriptors"][s1], size, size,
                                "full", force)
        before = len(force)
        new = []
        for side in (0, 1):
            new += _force_from(r["decisions"][side], pk[side], r["ind"][side],
                               force, side)
        keep_margins += new
        if len(force) == before:
            break
    gap = max(keep_margins, default=0.0)

    # the program's matches of valid rows, in the reference's indices
    m0 = got["matches0"]
    if bool(((m0 >= 0) & ~feats0["valid"]).any()):
        return {"matcher_gap": IMPOSSIBLE, "mscore_gap": IMPOSSIBLE,
                "counts": r["counts"], "decisions": r["decisions"]}
    slot_to_ref1 = torch.full((k,), -1, dtype=torch.int64, device=m0.device)
    slot_to_ref1[s1] = torch.arange(s1.numel(), device=m0.device)
    claim_ref = torch.where(m0[s0] >= 0, slot_to_ref1[m0[s0].clamp(min=0)],
                            torch.full_like(m0[s0], -2))
    ind0, ind1 = r["ind"]
    m, n = ind0.numel(), ind1.numel()
    kept_pos1 = torch.full((s1.numel() + 1,), -1, dtype=torch.int64,
                           device=m0.device)
    kept_pos1[ind1] = torch.arange(n, device=m0.device)
    claim = claim_ref[ind0]
    matched = claim != -2
    col = torch.where(claim >= 0, kept_pos1[claim.clamp(min=0)], claim)
    if bool((matched & (col < 0)).any()):
        gap = IMPOSSIBLE
    pruned_rows = torch.ones(s0.numel(), dtype=torch.bool, device=m0.device)
    pruned_rows[ind0] = False
    if bool((pruned_rows & (claim_ref != -2)).any()):
        gap = IMPOSSIBLE
    if m and n:
        g = _assignment_gaps(r["scores"][:m, :n][None], col[None],
                             matched[None])
        gap = max(gap, _max(g))
    both = (r["matches0"][ind0] >= 0) & matched & \
        (r["matches0"][ind0] == claim)
    ms_port = got["mscores0"][s0][ind0]
    ms_ref = r["mscores0"][ind0]
    mscore = _max((ms_port - ms_ref).abs()[both])
    return {"matcher_gap": gap, "mscore_gap": mscore,
            "counts": r["counts"], "decisions": r["decisions"]}


def verdict(numbers: Dict[str, float], own: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict]]:
    """All numbers within their limits, `LIMITS` and the pipeline's `own`
    -> (correct, {name: value, limit}). A limit defined in both, or a
    number without a limit, is refused."""
    twice = sorted(set(own) & set(LIMITS))
    if twice:
        raise ValueError(f"limits defined twice: {twice}")
    lim = {**LIMITS, **own}
    unknown = sorted(set(numbers) - set(lim))
    if unknown:
        raise KeyError(f"no limit for {unknown}")
    shown = {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()}
    return all(v <= lim[k] for k, v in numbers.items()), shown


def merge(parts: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the parts."""
    out: Dict[str, float] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out.get(k, 0.0), float(v))
    return out
