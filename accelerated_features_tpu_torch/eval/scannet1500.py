"""ScanNet-1500 relative-pose benchmark harness (counterpart of the JAX
package's `eval/scannet1500.py`).

Protocol of the reference evaluation: LoFTR's pair list (`test.npz`, rows
of scene, sub, frame0, frame1), each scene's colour intrinsics and
camera-to-world poses from the ScanNet export, matches extracted once (an
`.npz` cache with an identity check), a RANSAC threshold sweep over
0.5 .. 6.0 px with the best mean AUC chosen, and AUC@{5,10,20} of
max(angular R error, angular t error). Poses by the native posekit
LO-RANSAC (`geometry/pose.py`) by default, or by the batched 8-point MSAC
on the device (`pose_backend="gpu"`, one process).

Frames are JPEG and read by `utils/imageio` without cv2. Batched mode
(`extract_matches_batched`) runs kernels A, B and C on the card: all
frames are 640x480, so extraction runs as full batches and matching as
the batched masked MNN (`eval/batched.py`).

    python -m accelerated_features_tpu_torch.eval.scannet1500 \\
        --data_root tests/fixtures/scannet1500_mini \\
        --npz tests/fixtures/scannet1500_mini/test.npz --batched \\
        [--top_k 4096] [--device cpu] [--out sweep.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.imageio import imread
from .metrics import pose_errors_to_summary, relative_pose_error

THRESHOLDS = [0.5 * i for i in range(1, 13)]  # 0.5 .. 6.0 px

Device = Optional[Union[str, torch.device]]
Matches = List[Tuple[np.ndarray, np.ndarray]]


def load_pair_list(npz_path: str) -> List[dict]:
    """LoFTR's `test.npz`: array 'name' of (scene, sub, frame0, frame1)
    rows -> the paths of each pair's frames, poses and intrinsics."""
    names = np.load(npz_path)["name"]
    pairs = []
    for scene, sub, i0, i1 in names:
        sname = f"scene{int(scene):04d}_{int(sub):02d}"
        pairs.append({
            "scene": sname,
            "im0": f"{sname}/color/{int(i0)}.jpg",
            "im1": f"{sname}/color/{int(i1)}.jpg",
            "pose0": f"{sname}/pose/{int(i0)}.txt",
            "pose1": f"{sname}/pose/{int(i1)}.txt",
            "intrinsic": f"{sname}/intrinsic/intrinsic_color.txt",
        })
    return pairs


def read_pose(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(4, 4)


def rel_pose_0to1(pose0_c2w: np.ndarray, pose1_c2w: np.ndarray
                  ) -> np.ndarray:
    """ScanNet poses are camera-to-world: T_0to1 = inv(pose1) @ pose0."""
    return np.linalg.inv(pose1_c2w) @ pose0_c2w


def _read_match_cache(cache_path: Optional[str], cache_meta: Optional[str],
                      n_pairs: int) -> Optional[Matches]:
    """The cached matches if the file exists and was written for this
    configuration (`cache_meta`; None accepts any) and pair count, else
    None (with a notice when the file is another configuration's)."""
    if not (cache_path and os.path.exists(cache_path)):
        return None
    data = np.load(cache_path, allow_pickle=True)
    stored_meta = str(data["meta"]) if "meta" in data else None
    if ((cache_meta is None or stored_meta == cache_meta)
            and len(data["matches"]) == n_pairs):
        return [tuple(m) for m in data["matches"]]
    print(f"[ScanNet-1500] cache {cache_path} is for a different "
          f"configuration ({stored_meta!r} != {cache_meta!r}); "
          "recomputing matches")
    return None


def _write_match_cache(cache_path: str, matches: Matches,
                       cache_meta: Optional[str]) -> None:
    # an explicit object array: np.asarray on equal-shape match lists would
    # make a numeric 4-D array that does not read back as a list of pairs
    arr = np.empty(len(matches), dtype=object)
    for i, m in enumerate(matches):
        arr[i] = m
    np.savez_compressed(cache_path, matches=arr,
                        meta=np.str_(cache_meta or ""))


def extract_matches(matcher_fn: Callable, data_root: str, pairs: List[dict],
                    cache_path: Optional[str] = None, progress: bool = True,
                    cache_meta: Optional[str] = None) -> Matches:
    """Run `matcher_fn(im0, im1) -> (mkpts0, mkpts1)` over the pairs, the
    frames read by `utils/imageio.imread`, with the `.npz` match cache.
    `cache_meta` names the matcher's configuration; a cache written for
    another configuration or pair count is recomputed."""
    cached = _read_match_cache(cache_path, cache_meta, len(pairs))
    if cached is not None:
        return cached
    out = []
    it = pairs
    if progress:
        try:
            import tqdm
            it = tqdm.tqdm(pairs, desc="[ScanNet-1500] matching")
        except ImportError:
            pass
    for pair in it:
        im0 = imread(os.path.join(data_root, pair["im0"]))
        im1 = imread(os.path.join(data_root, pair["im1"]))
        mk0, mk1 = matcher_fn(im0, im1)
        out.append((np.asarray(mk0), np.asarray(mk1)))
    if cache_path:
        _write_match_cache(cache_path, out, cache_meta)
    return out


def extract_matches_batched(data_root: str, pairs: List[dict],
                            top_k: int = 4096, weights: Optional[str] = None,
                            batch_size: int = 16,
                            detection_threshold: float = 0.05,
                            cache_path: Optional[str] = None,
                            cache_meta: Optional[str] = None,
                            progress: bool = True, device: Device = None
                            ) -> Matches:
    """Sparse matching of every pair in batches: each distinct frame is
    extracted once (`extract_features_batched`, batches of equal size),
    then the pairs are matched by the batched masked MNN
    (`match_pairs_batched`); per pair the result of `XFeat.match_xfeat`.
    `weights` None is the repository's trained extractor; `device` None
    is the GPU. Honours the match cache of `extract_matches`."""
    cached = _read_match_cache(cache_path, cache_meta, len(pairs))
    if cached is not None:
        return cached

    from ..api import DEFAULT_WEIGHTS, XFeat
    from .batched import extract_features_batched, match_pairs_batched

    xf = XFeat(weights or DEFAULT_WEIGHTS, top_k, detection_threshold,
               device=device)
    # one extraction a frame: pairs share frames
    by_path: Dict[str, List[tuple]] = {}
    for i, pair in enumerate(pairs):
        by_path.setdefault(pair["im0"], []).append((i, 0))
        by_path.setdefault(pair["im1"], []).append((i, 1))
    feats_by_path = extract_features_batched(
        xf.model.params, [(p, p, None) for p in by_path], data_root, top_k,
        detection_threshold, None, batch_size, progress,
        tag="ScanNet-1500 batched")
    feats = {key: feats_by_path[path]
             for path, keys in by_path.items() for key in keys}
    out = match_pairs_batched(
        feats, [((i, 0), (i, 1)) for i in range(len(pairs))], batch_size,
        device=xf.device)
    if cache_path:
        _write_match_cache(cache_path, out, cache_meta)
    return out


def _pose_error_one(args) -> float:
    """max(R error, t error) in degrees of one pair at one threshold, 180
    when fewer than 5 matches or no pose. args: (mkpts0, mkpts1, K,
    T_0to1, threshold, backend[, device])."""
    mk0, mk1, K, T_0to1, thr, backend = args[:6]
    device = args[6] if len(args) > 6 else None
    err = {"R_err": 180.0, "t_err": 180.0}
    if len(mk0) >= 5:
        from ..geometry import get_pose_estimator
        res = get_pose_estimator(backend, device)(
            mk0, mk1, K, K, max_epipolar_error=thr, success_prob=0.99999)
        if res is not None:
            R, t, _ = res
            err = relative_pose_error(T_0to1, R, t)
    return max(err["R_err"], err["t_err"])


def run_threshold_sweep(matches: Matches, gt: List[dict],
                        thresholds=THRESHOLDS, workers: int = 0,
                        cache_dir: Optional[str] = None,
                        pose_backend: str = "posekit", device: Device = None
                        ) -> Dict[str, Dict[str, float]]:
    """The pose summary at every RANSAC threshold (`thr_<t>` keys). With
    `cache_dir`, each threshold's pose errors are kept in a file keyed by
    the backend and a digest of the matches, so an interrupted sweep
    resumes. `workers` > 1 runs posekit in one spawn pool for the whole
    sweep (each process builds or loads the library at its first call);
    the device backend runs in this process only."""
    if workers > 1 and pose_backend != "posekit":
        raise ValueError(f"pose_backend={pose_backend!r} runs on one device "
                         f"in this process; use workers <= 1")
    results = {}
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        h = hashlib.sha1()
        for mk0, mk1 in matches:
            h.update(np.ascontiguousarray(mk0, np.float32).tobytes())
            h.update(np.ascontiguousarray(mk1, np.float32).tobytes())
        tag = f"{pose_backend}_{h.hexdigest()[:10]}"
    dev = None if device is None else str(device)
    ex = None
    if workers > 1:
        import multiprocessing as mp
        ex = ProcessPoolExecutor(max_workers=workers,
                                 mp_context=mp.get_context("spawn"))
    try:
        for thr in thresholds:
            err_path = (os.path.join(cache_dir,
                                     f"errors_{tag}_thr_{thr:g}.npy")
                        if cache_dir else None)
            if err_path and os.path.exists(err_path):
                pose_errs = np.load(err_path).tolist()
            else:
                jobs = [(m[0], m[1], g["K"], g["T_0to1"], thr, pose_backend,
                         dev) for m, g in zip(matches, gt)]
                if ex is not None:
                    pose_errs = list(ex.map(_pose_error_one, jobs,
                                            chunksize=16))
                else:
                    pose_errs = [_pose_error_one(j) for j in jobs]
                if err_path:
                    np.save(err_path, np.asarray(pose_errs, np.float64))
            errors = [{"R_err": e, "t_err": e} for e in pose_errs]
            results[f"thr_{thr}"] = pose_errors_to_summary(errors)
    finally:
        if ex is not None:
            ex.shutdown()
    return results


def best_result(sweep: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The threshold with the best mean of AUC@5, @10 and @20."""
    best_key = max(sweep, key=lambda k: (sweep[k]["auc@5"]
                                         + sweep[k]["auc@10"]
                                         + sweep[k]["auc@20"]) / 3)
    out = dict(sweep[best_key])
    out["best_threshold"] = float(best_key.split("_")[1])
    return out


def load_ground_truth(data_root: str, pairs: List[dict]) -> List[dict]:
    """Each pair's colour intrinsics K and relative pose T_0to1."""
    gt = []
    for pair in pairs:
        K = np.loadtxt(os.path.join(data_root, pair["intrinsic"]))[:3, :3]
        T = rel_pose_0to1(read_pose(os.path.join(data_root, pair["pose0"])),
                          read_pose(os.path.join(data_root, pair["pose1"])))
        gt.append({"K": K, "T_0to1": T})
    return gt


def run_benchmark(matcher_fn: Optional[Callable], data_root: str,
                  npz_path: str, cache_path: Optional[str] = None,
                  workers: int = 0, cache_dir: Optional[str] = None,
                  summary_path: Optional[str] = None,
                  pose_backend: str = "posekit",
                  cache_meta: Optional[str] = None,
                  batched: Optional[dict] = None, device: Device = None
                  ) -> Dict[str, float]:
    """Matches (per pair by `matcher_fn`, or with `batched`, a dict of
    `extract_matches_batched` keywords: top_k, weights, batch_size,
    detection_threshold), then the threshold sweep; returns the best
    threshold's summary and writes the sweep and it to `summary_path`.
    `device` is where batched extraction and the device pose backend run
    (None: the GPU)."""
    pairs = load_pair_list(npz_path)
    if batched is not None:
        matches = extract_matches_batched(
            data_root, pairs, cache_path=cache_path, cache_meta=cache_meta,
            device=device, **batched)
    else:
        matches = extract_matches(matcher_fn, data_root, pairs, cache_path,
                                  cache_meta=cache_meta)
    sweep = run_threshold_sweep(matches, load_ground_truth(data_root, pairs),
                                workers=workers, cache_dir=cache_dir,
                                pose_backend=pose_backend, device=device)
    best = best_result(sweep)
    if summary_path:
        with open(summary_path, "w") as f:
            json.dump({"sweep": sweep, "best": best}, f, indent=2)
    return best


def report(summary_paths: List[str],
           metric_keys=("auc@5", "auc@10", "auc@20", "mAcc")):
    """A pandas table of saved sweep JSONs (pandas imported only here):
    one row a (run, threshold), and a 'best' row a run. Printed and
    returned."""
    import pandas as pd

    def get(summ, k):
        # mAcc, the mean of acc@{5,10,20}, is derived, not stored
        if k == "mAcc" and k not in summ:
            accs = [summ.get(f"acc@{t}") for t in (5, 10, 20)]
            return (float(np.mean(accs))
                    if all(a is not None for a in accs) else None)
        return summ.get(k)

    rows = []
    for path in summary_paths:
        with open(path) as f:
            data = json.load(f)
        run = os.path.splitext(os.path.basename(path))[0]
        for key, summ in data.get("sweep", {}).items():
            rows.append({"run": run, "threshold": float(key.split("_")[1]),
                         **{k: get(summ, k) for k in metric_keys}})
        best = data.get("best")
        if best:
            rows.append({"run": run, "threshold": best.get("best_threshold"),
                         "best": True,
                         **{k: get(best, k) for k in metric_keys}})
    df = pd.DataFrame(rows)
    if not df.empty:
        df = df.sort_values(["run", "threshold"]).reset_index(drop=True)
    print(df.to_string(index=False))
    return df


def main(argv=None):
    ap = argparse.ArgumentParser(description="ScanNet-1500 pose benchmark")
    ap.add_argument("--show", nargs="*", default=None,
                    help="print a table of saved sweep JSONs instead of "
                         "running the benchmark")
    ap.add_argument("--data_root", type=str, default=None)
    ap.add_argument("--npz", type=str, default=None,
                    help="LoFTR test.npz pair list")
    ap.add_argument("--matcher", type=str, default="xfeat",
                    choices=["xfeat", "xfeat-star", "xfeat-lighterglue"])
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--lg_weights", type=str, default=None,
                    help="LighterGlue checkpoint (.npz) for the "
                         "xfeat-lighterglue matcher")
    ap.add_argument("--top_k", type=int, default=4096)
    ap.add_argument("--cache", type=str, default=None)
    ap.add_argument("--cache_dir", type=str, default=None,
                    help="per-threshold pose-error cache directory")
    ap.add_argument("--out", type=str, default=None,
                    help="write the sweep and the best summary here (JSON)")
    ap.add_argument("--workers", type=int, default=os.cpu_count())
    ap.add_argument("--pose_backend", type=str, default="posekit",
                    choices=["posekit", "gpu"],
                    help="posekit: native 5-pt LO-RANSAC on the host; gpu: "
                         "batched 8-pt MSAC on the device (one process)")
    ap.add_argument("--batched", action="store_true",
                    help="batched extraction + batched MNN (sparse 'xfeat' "
                         "matcher only; the per-pair results)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    args = ap.parse_args(argv)
    if args.batched and args.matcher != "xfeat":
        ap.error("--batched supports the sparse 'xfeat' matcher")
    if args.pose_backend == "gpu":
        args.workers = 1

    if args.show is not None:
        report(args.show)
        return
    if not args.data_root or not args.npz:
        ap.error("--data_root and --npz are required unless --show is given")

    fn = None
    if not args.batched:
        from .megadepth1500 import make_matcher
        fn = make_matcher(args.matcher, args.top_k, args.weights,
                          lg_weights=args.lg_weights, device=args.device)
    meta = (f"matcher={args.matcher} top_k={args.top_k} "
            f"weights={args.weights} lg_weights={args.lg_weights} "
            f"npz={os.path.basename(args.npz)} "
            f"mode={'batched-f32' if args.batched else 'perpair'}")
    batched = ({"top_k": args.top_k, "weights": args.weights,
                "batch_size": args.batch_size} if args.batched else None)
    print(json.dumps(run_benchmark(fn, args.data_root, args.npz, args.cache,
                                   args.workers, cache_dir=args.cache_dir,
                                   summary_path=args.out,
                                   pose_backend=args.pose_backend,
                                   cache_meta=meta, batched=batched,
                                   device=args.device), indent=2))


if __name__ == "__main__":
    main()
