"""Per-pair record of the holdout pose eval, and the comparison of two
records: where a pose AUC measured on one machine and device differs from
another's, which pairs moved, and whether their matches or the pose
estimator moved them.

    python3 -m accelerated_features_tpu_torch.tools.holdout_pairs \\
        record OUT.npz [--matcher xfeat] [--top_k 2048] [--limit 100] \\
        [--lg_min_conf 0.005] [--device cpu]
    python3 -m accelerated_features_tpu_torch.tools.holdout_pairs \\
        compare A.npz B.npz

`record` runs `eval/megadepth1500`'s protocol on the committed holdout
(trained extractor; LighterGlue's trained matcher for
`xfeat-lighterglue`; posekit) and saves each pair's matches and its
R_err, t_err and inlier count. `compare` prints both AUC@5/10/20, the
pairs whose match sets differ, the pairs whose max(R_err, t_err) differs
by more than 1 deg, and, for those, that error re-estimated here by
posekit on each record's matches: equal to the record's own when the two
machines' posekit builds agree on the same matches.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..eval import megadepth1500 as md
from ..eval.metrics import pose_errors_to_summary
from ..utils.imageio import imread

ROOT = Path(__file__).resolve().parents[2]
HOLDOUT = ROOT / "artifacts" / "rendered_pose_holdout"


def record(args) -> None:
    import torch
    fn = md.make_matcher(
        args.matcher, args.top_k, lg_min_conf=args.lg_min_conf,
        lg_weights=str(ROOT / "artifacts" / "lighterglue_ft_ckpt7791.npz"),
        device=args.device)
    pairs = md.load_pairs(str(HOLDOUT / "rendered_pose_pairs.json"))
    out, errs = {}, []
    for i, pair in enumerate(pairs[:args.limit]):
        ims = [imread(HOLDOUT / n) for n in pair["pair_names"]]
        mk0, mk1 = fn(*ims)
        e = md.compute_pose_error(pair, mk0, mk1)
        out[f"m{i}"] = np.concatenate([mk0, mk1], 1).astype(np.float32)
        errs.append((e["R_err"], e["t_err"], e["n_inliers"]))
    device = "cpu" if args.device == "cpu" else \
        torch.cuda.get_device_name(0)
    np.savez(args.out, errs=np.asarray(errs), device=device,
             matcher=args.matcher, **out)
    print(f"{args.matcher} on {device}: {_summary(np.asarray(errs))}")


def _summary(errs: np.ndarray) -> dict:
    s = pose_errors_to_summary([{"R_err": r, "t_err": t}
                                for r, t, _ in errs])
    return {k: round(float(s[k]), 4) for k in ("auc@5", "auc@10", "auc@20")}


def _posekit_err(i: int, m: np.ndarray) -> float:
    pair = md.load_pairs(str(HOLDOUT / "rendered_pose_pairs.json"))[i]
    e = md.compute_pose_error(pair, m[:, :2], m[:, 2:])
    return max(e["R_err"], e["t_err"])


def compare(a_path: str, b_path: str) -> None:
    a, b = np.load(a_path), np.load(b_path)
    ea, eb = a["errs"], b["errs"]
    print(f"A {a['matcher']} on {a['device']}: {_summary(ea)}")
    print(f"B {b['matcher']} on {b['device']}: {_summary(eb)}")
    n = min(len(ea), len(eb))
    differ = [i for i in range(n)
              if {tuple(r) for r in a[f"m{i}"].tolist()}
              != {tuple(r) for r in b[f"m{i}"].tolist()}]
    print(f"{len(differ)} of {n} pairs have different match sets: "
          f"{differ}")
    ma, mb = ea[:n, :2].max(1), eb[:n, :2].max(1)
    for i in np.nonzero(np.abs(ma - mb) > 1.0)[0]:
        print(f"pair {i}: max err A {ma[i]:.3f} B {mb[i]:.3f} deg, "
              f"matches {'differ' if i in differ else 'equal'} "
              f"({len(a[f'm{i}'])} vs {len(b[f'm{i}'])}); posekit here on "
              f"A's matches {_posekit_err(i, a[f'm{i}']):.3f}, on B's "
              f"{_posekit_err(i, b[f'm{i}']):.3f} deg")


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("out")
    r.add_argument("--matcher", default="xfeat",
                   choices=["xfeat", "xfeat-star", "xfeat-lighterglue"])
    r.add_argument("--top_k", type=int, default=2048)
    r.add_argument("--limit", type=int, default=100)
    r.add_argument("--lg_min_conf", type=float, default=0.005)
    r.add_argument("--device", default=None)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "record":
        record(args)
    else:
        compare(args.a, args.b)


if __name__ == "__main__":
    main()
