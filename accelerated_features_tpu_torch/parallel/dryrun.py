"""Run a function on a spawned group of ranks, and the multi-GPU dry run:
the counterpart of the JAX package's `__graft_entry__.dryrun_multichip`.

`run_ranks(fn, world_size, *args)` spawns `world_size` processes, starts
a process group among them on a free localhost port (one rank a card
over NCCL by default; gloo when the host has fewer cards than ranks, and
gloo on the CPU with `device="cpu"`), calls `fn(mesh_rank, *args)` in
each and returns the ranks' results in rank order. A rank that raises
makes the whole call raise, with that rank's traceback; a group that has
not finished within `timeout` seconds is killed and the call raises
`TimeoutError`. `fn` and its arguments are pickled: `fn` must be a
module-level function.

`dryrun_multigpu(world_size)` runs the four sharded paths on tiny shapes
over a (n/2, 2) mesh where n is even, else (n, 1): the data- and
tensor-parallel train step, sequence-parallel MNN, sequence-parallel
LighterGlue and point-sharded bundle adjustment. It runs on the cards
(kernel D in LighterGlue) unless it is given `device="cpu"`:

    python -m accelerated_features_tpu_torch.parallel.dryrun 4
    python -m accelerated_features_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, device, backend, threads, args,
               results):
    try:
        import torch

        from .distributed import initialize, shutdown
        torch.set_num_threads(threads)
        initialize(f"localhost:{port}", world_size, rank, device=device,
                   backend=backend)
        try:
            out = fn(rank, *args)
        finally:
            shutdown()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *args: Any,
              device: str = "cuda", backend: Optional[str] = None,
              timeout: float = 180.0, threads: int = 1) -> List[Any]:
    """fn(rank, *args) on `world_size` spawned ranks; their results in
    rank order. `device="cuda"` puts rank r on card r modulo the cards:
    NCCL when there are as many cards as ranks, else gloo (NCCL takes one
    rank a card; gloo runs CUDA tensors through the host), or the given
    `backend`. `device="cpu"`: gloo ranks on the CPU."""
    if device.startswith("cuda") and backend is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks(device='cuda') found no CUDA "
                               "device; pass device='cpu' for gloo ranks on "
                               "the CPU")
        if torch.cuda.device_count() < world_size:
            backend = "gloo"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, device, backend,
                               threads, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"did not finish in {timeout:.0f} s "
                                   f"(finished: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {fn.__name__} "
                                       f"died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def _dryrun_rank(rank: int, world_size: int, device: str) -> dict:
    import numpy as np
    import torch

    from ..models.lighterglue import init_lighterglue_params
    from ..models.params import init_xfeat_params, params_from_jax
    from ..sfm.ba import BAProblem
    from ..train import optim
    from ..train.trainer import (TrainConfig, init_train_state,
                                 make_sharded_train_step)
    from .ba import bundle_adjust_point_sharded
    from .lighterglue_sp import lighterglue_forward_sp
    from .matching import mnn_match_sp
    from .mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device.startswith("cuda") else torch.device("cpu")

    def on_dev(tree):
        return optim.tree_map(lambda t: t.to(dev), tree)
    model = 2 if world_size % 2 == 0 else 1
    mesh = make_mesh((world_size // model, model))
    cfg = TrainConfig()
    state = init_train_state(on_dev(params_from_jax(init_xfeat_params())),
                             cfg)
    B, H, W, M = mesh.size("data") * 2, 64, 64, 64
    rng = np.random.default_rng(0)
    batch = {
        "image0": rng.uniform(0, 1, (B, H, W, 1)),
        "image1": rng.uniform(0, 1, (B, H, W, 1)),
        "corrs": rng.integers(0, H // 8, (B, M, 4)),
        "corr_valid": rng.uniform(size=(B, M)) > 0.3,
        "distill_labels0": rng.integers(0, 65, (B, H // 8, W // 8)),
        "distill_labels1": rng.integers(0, 65, (B, H // 8, W // 8)),
    }
    batch = {k: torch.from_numpy(v.astype(
        np.float32 if v.dtype == np.float64 else
        (bool if v.dtype == bool else np.int64))).to(dev)
        for k, v in batch.items()}
    step_fn, state_sh, shard_batch = make_sharded_train_step(
        mesh, state, batch, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    new_state, metrics = step_fn(state_sh, shard_batch(batch), gen)
    loss = float(metrics["loss_total"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    d1 = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    d2 = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    d1, d2 = d1.to(dev), d2.to(dev)
    _, mnn_mask = mnn_match_sp(mesh, d1, d2)

    lg = on_dev(init_lighterglue_params(torch.Generator().manual_seed(2)))
    size = torch.tensor([[128.0, 128.0]], device=dev)
    kpts = torch.from_numpy(rng.uniform(0, 128, (2, 1, 128, 2)).astype(
        np.float32)).to(dev)
    desc = torch.from_numpy(rng.normal(size=(2, 1, 128, 64)).astype(
        np.float32)).to(dev)
    m0, _ = lighterglue_forward_sp(mesh, lg, kpts[0], kpts[1], desc[0],
                                   desc[1], size, size)

    n_cams, n_pts = 4, 16 * world_size
    pts = (rng.uniform(-1, 1, (n_pts, 3)) + [0, 0, 5]).astype(np.float32)
    cams = np.zeros((n_cams, 6), np.float32)
    cams[:, 3] = np.linspace(0, 0.5, n_cams)
    obs_cam = np.repeat(np.arange(n_cams), n_pts)
    obs_pt = np.tile(np.arange(n_pts), n_cams)
    uv = pts[obs_pt, :2] / pts[obs_pt, 2:] * 100.0 + 64.0
    prob = BAProblem(
        torch.from_numpy(cams), torch.from_numpy(pts + np.float32(0.01)),
        torch.tensor([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]),
        torch.from_numpy(obs_cam), torch.from_numpy(obs_pt),
        torch.from_numpy(uv.astype(np.float32)),
        torch.ones(len(obs_cam), dtype=torch.bool)).to(dev)
    _, info = bundle_adjust_point_sharded(prob, mesh, iters=2, cg_iters=10)
    if float(info["final_cost"]) > float(info["initial_cost"]):
        raise RuntimeError("the point-sharded BA raised the cost")
    return {"mesh": dict(mesh.shape), "loss": loss,
            "step": int(new_state["step"]), "sp_mnn": int(mnn_mask.sum()),
            "lg_matches": int((m0 >= 0).sum()),
            "ba_cost": float(info["final_cost"])}


def dryrun_multigpu(world_size: int, timeout: float = 300.0,
                    device: str = "cuda") -> dict:
    """The four sharded paths on `world_size` ranks (`run_ranks`: on the
    cards unless `device="cpu"`); returns rank 0's summary (every rank's
    must agree) and prints it."""
    import torch
    if device.startswith("cuda") and torch.cuda.is_available():
        from ..ops.cuda._build import build_all
        build_all()   # once here, not in every rank
    outs = run_ranks(_dryrun_rank, world_size, world_size, device,
                     device=device, timeout=timeout)
    for o in outs[1:]:
        if o != outs[0]:
            raise RuntimeError(f"ranks disagree: {outs}")
    o = outs[0]
    print(f"dryrun_multigpu({world_size}, {device}): mesh={o['mesh']} "
          f"loss={o['loss']:.4f} step={o['step']} sp_mnn={o['sp_mnn']} "
          f"lg_matches={o['lg_matches']} ba_cost={o['ba_cost']:.4f}")
    return o


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the multi-GPU dry run")
    ap.add_argument("world_size", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args()
    dryrun_multigpu(a.world_size, device=a.device)
