"""Headline benchmark of the port (counterpart of the JAX package's root
`bench.py`): batched VGA sparse extraction throughput on one card, then
the secondary headline numbers, in ONE JSON line under JAX's keys.

    python -m accelerated_features_tpu_torch.apps.bench [--device cpu]

Environment, as JAX's: BENCH_BATCH (64), BENCH_TOPK (4096), BENCH_ITERS
(20), BENCH_SKIP_ACCURATE=1, BENCH_SKIP_SECONDARY=1. The arguments
(`--batch`, `--top_k`, `--iters`, `--res`, `--accurate_res`, `--mnn_k`,
`--lg_k`, `--ba`) override them, so that a test can run the program at
tiny shapes; the keys follow the sizes and are JAX's at the defaults.

The headline program is JAX's: the full sparse pipeline
(`ops/extraction.detect_and_compute`: backbone in bfloat16, heatmap
decode, kernel A's NMS, score and top-k, kernel B's bicubic descriptors)
on B uint8 frames of seeded noise at threshold 0.05, with random weights.
An untrained keypoint head spreads its softmax at ~1/65 a cell, under
0.05, so no keypoint passes and kernel B samples padding (JAX's program
too: 0 of 4096 on its draw). The line carries `valid_keypoints_per_frame`
beside the number so that the defect shows.

Keys: `metric` (`sparse_extraction_vga_fps_b{B}_k{K}`), `value`, `unit`,
`vs_baseline` (against the reference's 1,400 FPS on an RTX 4090),
`dispatch_loop_fps`, `accurate_1024x768_fps`, `fused_mnn_k8192_ms`
(kernel C), `lighterglue_k2048_ms` (kernel D, 24 launches),
`ba_lm_iters_per_s_c50_p5000`, and besides JAX's: `device` (the card's
name and power limit from nvidia-smi, or "not measured"), `call_ms` and
`floor_ms` (each metric's measured time of one call and its floor),
`valid_keypoints_per_frame`.

Timing: `utils/profiling.scan_time` (inputs perturbed every iteration,
the uint8 frames too; CUDA events around an eager loop, so every gap in
which the card waits for the host is in the time: where the card idles,
the rates are the host's, not one compiled program's as in JAX).
`dispatch_loop_fps` is the host clock around a loop of calls on the same
inputs that ends in a synchronize. Floors: the operations of the call,
counted by `utils/profiling.count_flops` on the plain path on the CPU
(the extraction at batch 1 times the batch), the BA's by
`parallel/ba.flops_accounting`, at the bf16 tensor-core peak of one H100
SXM, bytes left out. A time under its floor is published as `guarded_ms`'s
error string.

Differences from JAX's program: a secondary that fails is written as an
"error: ..." value as JAX writes it, and the accurate run's failure too
(JAX drops it), and the program exits 1 whenever a value of the line is
an error. There is no relay watchdog. Random weights come from torch
generators of seed 0, not `jax.random.key(0)`. The device is the GPU
unless `--device cpu` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..api import resolve_device
from ..ops.cuda.mnn import mnn_match_fused
from ..ops.extraction import detect_and_compute
from ..utils.profiling import scan_time
from .bench_suite import (_synth_ba, ba_floor_s, ba_step_call,
                          batch_floor_s, device_info, guarded_ms,
                          int_tuple, is_error, lighterglue_call,
                          lighterglue_floor_s, lighterglue_inputs,
                          mnn_floor_s, res_tag, xfeat_params)

BASELINE_FPS = 1400.0  # reference README.md:52 (RTX 4090, batched VGA)
THRESHOLD = 0.05       # JAX's bench.py


def sparse_program(top_k: int, threshold: float = THRESHOLD,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """The headline program: fn(params, images) -> `detect_and_compute`'s
    outputs (all of them, so that nothing is left undone)."""
    def run(params, images):
        return detect_and_compute(params, images, top_k, threshold,
                                  compute_dtype)
    return run


def metric_keys(batch: int = 64, top_k: int = 4096, res=(640, 480),
                accurate_res=(1024, 768), mnn_k: int = 8192,
                lg_k: int = 2048, ba=(50, 5000, 4)) -> Dict[str, str]:
    """The line's size-dependent keys at these sizes, JAX's at the
    defaults: the headline metric's name and the accurate, MNN,
    LighterGlue and BA keys."""
    aw, ah = accurate_res
    return {"headline": f"sparse_extraction_{res_tag(res)}_fps_b{batch}"
                        f"_k{top_k}",
            "accurate": f"accurate_{aw}x{ah}_fps",
            "mnn": f"fused_mnn_k{mnn_k}_ms",
            "lighterglue": f"lighterglue_k{lg_k}_ms",
            "ba": f"ba_lm_iters_per_s_c{ba[0]}_p{ba[1]}"}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(batch: int = 64, top_k: int = 4096, iters: int = 20,
            res=(640, 480), accurate_res=(1024, 768), mnn_k: int = 8192,
            lg_k: int = 2048, ba=(50, 5000, 4), skip_accurate: bool = False,
            skip_secondary: bool = False, device=None) -> Dict[str, Any]:
    """Run the benchmark; returns the line (a dict)."""
    dev = resolve_device(device)
    params = xfeat_params(dev)
    rng = np.random.default_rng(0)
    W, H = res
    images = torch.from_numpy(rng.integers(0, 256, (batch, H, W, 3)).astype(
        np.uint8)).to(dev)
    fn = sparse_program(top_k)
    count_fn = sparse_program(top_k, compute_dtype=torch.float32)
    keys = metric_keys(batch, top_k, res, accurate_res, mnn_k, lg_k, ba)
    call_ms: Dict[str, float] = {}
    floor_ms: Dict[str, float] = {}

    def record(key, seconds, floor, value):
        """Keep a metric's time and floor; its value, or `guarded_ms`'s
        error string when the time is under the floor."""
        call_ms[key], floor_ms[key] = seconds * 1e3, floor * 1e3
        return value if seconds >= floor else guarded_ms(seconds, floor)

    with torch.inference_mode():
        # primary: steady state over a loop of perturbed frames
        dt = scan_time(fn, params, images, iters=iters, perturb_ints=True)
        floor_main = batch_floor_s(count_fn, params, images)
        fps = record("value", dt, floor_main, batch / dt)
        if isinstance(fps, str):
            fps = 0.0  # published as an error, never as a fake record
        out = fn(params, images)
        valid = float(out["valid"].sum(1).float().mean())

        # secondary: the dispatch loop, same frames, ended by a synchronize
        for _ in range(3):
            fn(params, images)
        _synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(params, images)
        _synchronize(dev)
        disp_s = (time.perf_counter() - t0) / iters

        result: Dict[str, Any] = {
            "metric": keys["headline"],
            "value": round(fps, 1),
            "unit": "frames/s/chip",
            "vs_baseline": round(fps / BASELINE_FPS, 3),
            "dispatch_loop_fps": record("dispatch_loop_fps", disp_s,
                                        floor_main,
                                        round(batch / disp_s, 1)),
        }
        if fps == 0.0:
            result["error"] = guarded_ms(dt, floor_main)

        def secondary(key, run):
            """result[key] = run(), or the failure as an "error: ..." value
            with its traceback on stderr."""
            try:
                result[key] = run()
            except Exception as e:  # noqa: BLE001 -- reported, exits 1
                traceback.print_exc()
                result[key] = f"error: {e}"

        def accurate():   # the 1024x768 "Accurate" configuration
            aw, ah = accurate_res
            imgs = torch.from_numpy(rng.integers(
                0, 256, (batch, ah, aw, 3)).astype(np.uint8)).to(dev)
            t = scan_time(fn, params, imgs, iters=max(iters // 2, 5),
                          perturb_ints=True)
            return record(keys["accurate"], t,
                          batch_floor_s(count_fn, params, imgs),
                          round(batch / t, 1))

        def mnn():
            d1, d2 = (torch.from_numpy(rng.normal(size=(mnn_k, 64)).astype(
                np.float32)).to(dev) for _ in range(2))
            t = scan_time(mnn_match_fused, d1, d2, iters=iters)
            return record(keys["mnn"], t, mnn_floor_s(d1, d2),
                          round(t * 1e3, 3))

        def lighterglue():
            lparams, kpts, descs, size = lighterglue_inputs(rng, lg_k, dev)
            fl = lighterglue_call(size)
            t = scan_time(fl, lparams, kpts, descs,
                          iters=max(iters * 5, 100))
            return record(keys["lighterglue"], t,
                          lighterglue_floor_s(fl, lparams, kpts, descs),
                          round(t * 1e3, 3))

        @torch.inference_mode(False)   # as bench_suite.bench_ba
        def ba_rate():
            n_cams, n_pts, obs = ba
            prob = _synth_ba(n_cams, n_pts, obs, dev)
            t = scan_time(ba_step_call, prob, iters=max(iters // 2, 5))
            return record(keys["ba"], t, ba_floor_s(n_cams, n_pts,
                                                    n_pts * obs),
                          round(1.0 / t, 1))

        if not skip_accurate:
            secondary(keys["accurate"], accurate)
        if not skip_secondary:
            secondary(keys["mnn"], mnn)
            secondary(keys["lighterglue"], lighterglue)
            secondary(keys["ba"], ba_rate)

    result["device"] = device_info(dev)
    result["call_ms"] = call_ms
    result["floor_ms"] = floor_ms
    result["valid_keypoints_per_frame"] = valid
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Print the line; 1 if any value of it is an error, else 0."""
    env = os.environ
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int,
                    default=int(env.get("BENCH_BATCH", "64")))
    ap.add_argument("--top_k", type=int,
                    default=int(env.get("BENCH_TOPK", "4096")))
    ap.add_argument("--iters", type=int,
                    default=int(env.get("BENCH_ITERS", "20")))
    ap.add_argument("--res", type=int_tuple, default=(640, 480),
                    help="headline WxH")
    ap.add_argument("--accurate_res", type=int_tuple, default=(1024, 768))
    ap.add_argument("--mnn_k", type=int, default=8192)
    ap.add_argument("--lg_k", type=int, default=2048)
    ap.add_argument("--ba", type=int_tuple, default=(50, 5000, 4),
                    help="cameras,points,observations a point")
    ap.add_argument("--skip_accurate", action="store_true",
                    default=env.get("BENCH_SKIP_ACCURATE") == "1")
    ap.add_argument("--skip_secondary", action="store_true",
                    default=env.get("BENCH_SKIP_SECONDARY") == "1")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    a = ap.parse_args(argv)
    line = measure(a.batch, a.top_k, a.iters, a.res, a.accurate_res,
                   a.mnn_k, a.lg_k, a.ba, a.skip_accurate, a.skip_secondary,
                   a.device)
    print(json.dumps(line), flush=True)
    return 1 if any(is_error(v) for v in line.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
