"""Benchmark suite of the port (counterpart of the JAX package's root
`apps/bench_suite.py`): one JSON line per metric, under the JAX metric
names.

  * sparse extraction images a second (640x480, top-4096, bfloat16)
  * semi-dense dual-scale extraction images a second
  * fused MNN matching latency (kernel C, K = 4096 and 8192)
  * LighterGlue matching latency (K = 2048; kernel D, 24 launches)
  * bundle-adjustment LM steps a second (synthetic 100 cameras, 20,000
    points)
  * BA weak-scaling efficiency over a `torch.distributed` group
    (observations a rank held constant; with one rank the "unavailable"
    line)
  * XFeat training steps a second

    python -m accelerated_features_tpu_torch.apps.bench_suite [--quick] \\
        [--only extraction|matching|ba|train] [--trace DIR] [--device cpu]
    torchrun --nproc_per_node 4 -m \\
        accelerated_features_tpu_torch.apps.bench_suite --only ba

Under `torchrun` every rank runs every benchmark (each on its card) and
rank 0 prints. The sizes are JAX's (`--quick`: B = 32, one MNN size, BA
at 50 cameras and 5,000 points); the size arguments exist so that a test
can run the suite at tiny shapes, and the metric names follow the sizes.

Timing: `utils/profiling.scan_time`, inputs moved by a few ulps every
iteration, between CUDA events on the card (the host clock on the CPU).
JAX's `scan_time` times one compiled scan; here the loop is eager torch,
so the time includes every gap in which the card waits for the host, and
where the card idles (most of a call at these sizes) the rates are the
host's.

Each timed record also carries `ms`, the measured time of one call, and
`floor_ms`: the call's operations at the bf16 tensor-core peak of one
H100 SXM, bytes left out, as JAX's floor is. The operations are counted
by `utils/profiling.count_flops` on the plain path on the CPU (once a
run; at batch 1 times the batch where the work is linear in it), the BA's
by `parallel/ba.flops_accounting`. A time under its floor is published as
`guarded_ms`'s error string, and the run exits 1. Each record names
the device, with the card's power limit.

Weights are random, drawn by the port's `init_xfeat_params` and
`init_lighterglue_params` from torch generators of seed 0: other values
than JAX's `jax.random.key(0)` draws, the same shapes and work. The
device is the GPU unless `--device cpu` is given; without a card the run
raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import resolve_device
from ..models.lighterglue import init_lighterglue_params, lighterglue_forward
from ..models.params import init_xfeat_params, load_params, params_from_jax
from ..ops.cuda.mnn import mnn_match_fused
from ..ops.extraction import detect_and_compute, detect_and_compute_dense
from ..parallel.ba import (bundle_adjust_point_sharded, bundle_adjust_sharded,
                           flops_accounting)
from ..parallel.distributed import initialize
from ..parallel.mesh import make_mesh, world
from ..sfm.ba import BAProblem, ba_step, project
from ..train.optim import tree_map
from ..train.trainer import TrainConfig, init_train_state, train_step
from ..utils.profiling import (count_flops, device_trace, roofline_floor_s,
                               scan_time)

CG_ITERS = 30
Record = Dict[str, Any]


def device_info(device: torch.device) -> Dict[str, Any]:
    """{"name", "power_limit_w"}: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit` gives them ("not measured"
    where it cannot be read); on the CPU the name "cpu"."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": "not measured"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True,
                             timeout=60)
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        name, limit = smi.stdout.strip().splitlines()[index].rsplit(",", 1)
        return {"name": name.strip(), "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": torch.cuda.get_device_name(device),
                "power_limit_w": "not measured"}


def guarded_ms(measured_s, floor_s):
    """Refuse to publish a latency below the speed-of-light floor of the
    program (root `bench.py`'s function, which `bench` re-exports).
    Returns the rounded milliseconds, or an error string when below
    physics."""
    if floor_s > 0.0 and measured_s < floor_s:
        return (f"error: below SoL ({measured_s * 1e3:.3f} ms < "
                f"floor {floor_s * 1e3:.3f} ms)")
    return round(measured_s * 1e3, 3)


def is_error(value: Any) -> bool:
    return isinstance(value, str) and value.startswith("error")


def res_tag(res: Sequence[int]) -> str:
    """"vga" for 640x480 (JAX's names), else "WxH"."""
    w, h = res
    return "vga" if (w, h) == (640, 480) else f"{w}x{h}"


def emit(metric: str, value: Any, unit: str,
         baseline: Optional[float] = None, seconds: Optional[float] = None,
         floor_s: Optional[float] = None,
         device: Optional[Dict[str, Any]] = None) -> Record:
    """One metric's record, printed as a JSON line on rank 0. With
    `seconds` and `floor_s` the record carries `ms` and `floor_ms`, and a
    time under its floor replaces the value by `guarded_ms`'s error
    string."""
    rec: Record = {"metric": metric, "value": round(float(value), 3),
                   "unit": unit}
    if baseline:
        rec["vs_baseline"] = round(float(value) / baseline, 3)
    if seconds is not None and floor_s is not None:
        rec["ms"] = seconds * 1e3
        rec["floor_ms"] = floor_s * 1e3
        guarded = guarded_ms(seconds, floor_s)
        if is_error(guarded):
            rec["value"] = guarded
            rec.pop("vs_baseline", None)
    if device is not None:
        rec["device"] = device
    if world()[0] == 0:
        print(json.dumps(rec), flush=True)
    return rec


def time_call(fn: Callable, *args, iters: int = 20, **kwargs) -> float:
    """Seconds a call of fn(*args): `utils/profiling.scan_time`, inputs
    perturbed every iteration, CUDA events on the card."""
    return scan_time(fn, *args, iters=iters, **kwargs)


def to_cpu(tree: Any) -> Any:
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t,
                    tree)


def floor_s(flops: float) -> float:
    """Least seconds one H100 SXM takes for `flops` operations at its bf16
    tensor-core peak (bytes left out)."""
    return roofline_floor_s(flops, dtype="bf16")


def batch_floor_s(fn: Callable, params: Any, x: torch.Tensor) -> float:
    """`floor_s` of fn(params, x) over the batch x, whose work is linear
    in the batch: fn's operations on x's first item on the CPU (plain
    path, float32), times the batch."""
    with torch.inference_mode():
        return floor_s(x.shape[0] * count_flops(fn, to_cpu(params),
                                                x[:1].cpu()))


def xfeat_params(device: torch.device) -> Dict[str, Any]:
    """The random extractor, BatchNorm folded (JAX's
    `fold_batchnorm(init_xfeat_params(key(0)))` in the port's draw)."""
    return tree_map(lambda t: t.to(device), load_params(None))


def bench_extraction(args, device: torch.device, info) -> List[Record]:
    B, (W, H), K = args.batch, args.res, args.top_k
    params = xfeat_params(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (B, H, W, 3)).astype(
        np.float32)).to(device)
    tag = res_tag(args.res)

    def sparse(p, im, dtype=torch.bfloat16):
        return detect_and_compute(p, im, top_k=K, compute_dtype=dtype)

    def dense(p, im, dtype=torch.bfloat16):
        return detect_and_compute_dense(p, im, top_k=K, compute_dtype=dtype)
    out = []
    with torch.inference_mode():
        for name, fn, iters, baseline in (
                ("sparse", sparse, 10 if args.quick else 20, 1400.0),
                ("semidense", dense, 5 if args.quick else 10, None)):
            dt = time_call(fn, params, x, iters=iters)
            # operations counted in float32 on the CPU: the same products
            floor = batch_floor_s(lambda p, im: fn(p, im, torch.float32),
                                  params, x)
            out.append(emit(f"{name}_extraction_{tag}_fps", B / dt,
                            "frames/s/chip", baseline, dt, floor, info))
    return out


def lighterglue_inputs(rng: np.random.Generator, k: int,
                       device: torch.device):
    """JAX's LighterGlue bench inputs: random matcher weights, k keypoints
    uniform over 640x480 and standard normal descriptors (one image
    matched with itself), the image size."""
    lparams = tree_map(lambda t: t.to(device), init_lighterglue_params(
        torch.Generator().manual_seed(0)))
    kpts = torch.from_numpy(rng.uniform(0, [640, 480], (1, k, 2)).astype(
        np.float32)).to(device)
    descs = torch.from_numpy(rng.normal(size=(1, k, 64)).astype(
        np.float32)).to(device)
    size = torch.tensor([[640.0, 480.0]], device=device)
    return lparams, kpts, descs, size


def lighterglue_call(size: torch.Tensor) -> Callable:
    def run(p, k, d):
        return lighterglue_forward(p, k, k, d, d, size.to(k.device),
                                   size.to(k.device))
    return run


def mnn_floor_s(d1: torch.Tensor, d2: torch.Tensor) -> float:
    with torch.inference_mode():
        return floor_s(count_flops(mnn_match_fused, d1.cpu(), d2.cpu()))


def lighterglue_floor_s(fn: Callable, *inputs) -> float:
    with torch.inference_mode():
        return floor_s(count_flops(fn, *to_cpu(inputs)))


def bench_matching(args, device: torch.device, info) -> List[Record]:
    rng = np.random.default_rng(0)
    out = []
    with torch.inference_mode():
        for K in args.mnn_k:
            d1 = torch.from_numpy(rng.normal(size=(K, 64)).astype(
                np.float32)).to(device)
            d2 = torch.from_numpy(rng.normal(size=(K, 64)).astype(
                np.float32)).to(device)
            dt = time_call(mnn_match_fused, d1, d2)
            out.append(emit(f"fused_mnn_k{K}_ms", dt * 1e3, "ms/pair", None,
                            dt, mnn_floor_s(d1, d2), info))
        K = args.lg_k
        lparams, kpts, descs, size = lighterglue_inputs(rng, K, device)
        fl = lighterglue_call(size)
        dt = time_call(fl, lparams, kpts, descs, iters=10)
        out.append(emit(f"lighterglue_k{K}_ms", dt * 1e3, "ms/pair", None,
                        dt, lighterglue_floor_s(fl, lparams, kpts, descs),
                        info))
    return out


def _synth_ba(n_cams: int, n_pts: int, obs_per_pt: int,
              device: torch.device = torch.device("cpu")) -> BAProblem:
    """JAX's synthetic BA problem from the same numpy draws (seed 0): a
    row of cameras looking at points 6-14 units away, `obs_per_pt` random
    cameras a point, observations projected by `sfm.project` in float32
    plus 1 px of noise, cameras and points perturbed, camera 0 fixed.
    Indices are int64 (JAX: int32)."""
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    X = rng.uniform([-4, -4, 6], [4, 4, 14], (n_pts, 3)).astype(np.float32)
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 1] = np.linspace(-0.3, 0.3, n_cams)
    cams[:, 3] = np.linspace(-2, 2, n_cams)
    obs_cam = rng.integers(0, n_cams, n_pts * obs_per_pt)
    obs_pt = np.repeat(np.arange(n_pts, dtype=np.int64), obs_per_pt)
    uv = project(torch.from_numpy(cams)[obs_cam], torch.from_numpy(X)[obs_pt],
                 torch.from_numpy(K)).numpy()
    uv = uv + rng.normal(0, 1.0, (len(obs_cam), 2))
    cams_n = cams + rng.normal(0, 0.02, cams.shape).astype(np.float32)
    cams_n[0] = cams[0]
    X_n = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return BAProblem(cams=t(cams_n), points=t(X_n), K=t(K),
                     obs_cam=t(obs_cam.astype(np.int64)), obs_pt=t(obs_pt),
                     obs_uv=t(uv.astype(np.float32)),
                     obs_mask=t(np.ones(len(obs_cam), bool)),
                     fixed_cams=t(fixed))


def ba_step_call(q: BAProblem) -> BAProblem:
    """One LM step at lambda 1e-3 with 30 CG iterations (JAX's bench)."""
    return ba_step(q, 1e-3, cg_iters=CG_ITERS)[0]


def ba_floor_s(n_cams: int, n_pts: int, n_obs: int) -> float:
    return floor_s(flops_accounting(n_obs, n_cams, n_pts, CG_ITERS))


def bench_ba(args, device: torch.device, info) -> List[Record]:
    n_cams, n_pts, obs = args.ba
    p = _synth_ba(n_cams, n_pts, obs, device)
    ndev = world()[1]
    # ranks that meet in collectives must run as many calls: a fixed count
    fixed = {"min_window_s": 0.0} if ndev > 1 else {}
    # no inference mode: torch.func's forward-mode Jacobians of the BA make
    # no dual of an inference tensor on the card's torch build
    with torch.no_grad():
        dt = time_call(ba_step_call, p, iters=5 if args.quick else 10,
                       **fixed)
        out = [emit(f"ba_lm_iters_per_s_c{n_cams}_p{n_pts}", 1.0 / dt,
                    "iters/s", None, dt,
                    ba_floor_s(n_cams, n_pts, n_pts * obs), info)]
        if ndev == 1:
            out.append(emit("ba_weak_scaling_eff", -1,
                            "unavailable: single device on this host",
                            device=info))
            return out
        # weak scaling over the group: observations a rank held constant
        big = _synth_ba(n_cams, n_pts * ndev // 4, obs * 4, device)
        mesh = make_mesh((ndev, 1))
        t1 = time_call(ba_step_call, p, iters=3, **fixed)

        def run_sharded(q):
            return bundle_adjust_sharded(q, mesh, iters=1,
                                         cg_iters=CG_ITERS)[0]
        tN = time_call(run_sharded, big, iters=3, **fixed)
        out.append(emit(f"ba_weak_scaling_eff_{ndev}dev", t1 / tN, "x", 0.8,
                        device=info))

        # the point-partitioned solver (map sharded) on the same problem
        def run_pt(q):
            return bundle_adjust_point_sharded(q, mesh, iters=1,
                                               cg_iters=CG_ITERS)[0]
        tP = time_call(run_pt, big, iters=3, **fixed)
        out.append(emit(f"ba_point_weak_scaling_eff_{ndev}dev", t1 / tP, "x",
                        0.8, device=info))
    return out


def train_batch(B: int, W: int, H: int, M: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """JAX's bench batch (numpy seed 0): two gray images, M random /8
    correspondences an item, all valid."""
    rng = np.random.default_rng(0)
    b = {"image0": rng.uniform(0, 1, (B, H, W, 1)),
         "image1": rng.uniform(0, 1, (B, H, W, 1)),
         "corrs": rng.integers(2, H // 8 - 2, (B, M, 4))}
    out = {k: torch.from_numpy(v.astype(np.float32)).to(device)
           for k, v in b.items()}
    out["corr_valid"] = torch.ones((B, M), dtype=torch.bool, device=device)
    return out


def bench_training(args, device: torch.device, info) -> List[Record]:
    cfg = TrainConfig(use_distill=False)
    tree = params_from_jax(init_xfeat_params())
    state = init_train_state(tree_map(lambda t: t.to(device), tree), cfg)
    B, W, H, M = args.train
    batch = train_batch(B, W, H, M, device)
    gen = torch.Generator(device=device).manual_seed(0)

    def call(s, b=batch, g=gen):
        return train_step(s, b, g, cfg)[0]
    dt = time_call(call, state, iters=5 if args.quick else 10)
    # the step's work is linear in the batch: its operations at batch 1
    one = {k: v[:1].cpu() for k, v in batch.items()}
    flops = B * count_flops(call, init_train_state(tree, cfg), one,
                            torch.Generator().manual_seed(0))
    return [emit(f"train_step_per_s_b{B}_{W}x{H}", 1.0 / dt, "steps/s", None,
                 dt, floor_s(flops), info)]


def int_tuple(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.replace("x", ",").split(","))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", type=str, default=None,
                    choices=[None, "extraction", "matching", "ba", "train"])
    ap.add_argument("--trace", type=str, default=None,
                    help="write a torch.profiler trace (Chrome format) of "
                         "the benchmarked programs to this directory")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default: the GPU (raises without "
                         "one). 'cpu' runs the plain torch path")
    sizes = ap.add_argument_group("sizes (default: JAX's)")
    sizes.add_argument("--batch", type=int, default=None,
                       help="extraction batch (64; 32 with --quick)")
    sizes.add_argument("--res", type=int_tuple, default=(640, 480),
                       help="extraction WxH")
    sizes.add_argument("--top_k", type=int, default=4096)
    sizes.add_argument("--mnn_k", type=int_tuple, default=None,
                       help="MNN sizes K (4096,8192; 4096 with --quick)")
    sizes.add_argument("--lg_k", type=int, default=2048)
    sizes.add_argument("--ba", type=int_tuple, default=None,
                       help="cameras,points,observations a point "
                            "(100,20000,4; 50,5000,4 with --quick)")
    sizes.add_argument("--train", type=int_tuple, default=None,
                       help="B,W,H,M (4,256,192,256; with BENCH_TRAIN_FULL=1 "
                            "and not --quick, 10,800,608,1024)")
    args = ap.parse_args(argv)
    q = args.quick
    full = os.environ.get("BENCH_TRAIN_FULL") == "1" and not q
    if args.batch is None:
        args.batch = 32 if q else 64
    if args.mnn_k is None:
        args.mnn_k = (4096,) if q else (4096, 8192)
    if args.ba is None:
        args.ba = (50, 5000, 4) if q else (100, 20000, 4)
    if args.train is None:
        args.train = (10, 800, 608, 1024) if full else (4, 256, 192, 256)
    return args


def main(argv: Optional[Sequence[str]] = None) -> List[Record]:
    """Run the selected benchmarks; returns their records (printed on
    rank 0 as they come)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    initialize(device=device.type)   # a torchrun group, when there is one
    info = device_info(device)
    records: List[Record] = []
    trace = device_trace(args.trace) if args.trace else \
        contextlib.nullcontext()
    with trace:
        for name, bench in (("extraction", bench_extraction),
                            ("matching", bench_matching), ("ba", bench_ba),
                            ("train", bench_training)):
            if args.only in (None, name):
                records += bench(args, device, info)
    if args.trace:
        print(f"# trace written to {args.trace}", file=sys.stderr)
    return records


if __name__ == "__main__":
    sys.exit(1 if any(is_error(r["value"]) for r in main()) else 0)
