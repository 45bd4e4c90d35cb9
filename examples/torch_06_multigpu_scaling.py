"""The port's multi-GPU paths (port version of `06_multichip_scaling.py`):
data-parallel extraction, sequence-parallel MNN and LighterGlue, the
point-partitioned bundle adjuster and the data- and tensor-parallel train
step, on a (data, model) mesh of `torch.distributed` ranks.

On N cards of one host, one rank a card (NCCL):

    torchrun --nproc_per_node N examples/torch_06_multigpu_scaling.py

On the CPU, N gloo ranks spawned by the script itself:

    python examples/torch_06_multigpu_scaling.py --cpu_ranks 4

It prints each path's result and wall on rank 0. Walls from one card
(or from several ranks sharing one card) are no scaling number: the
ranks then share one device's compute, and gloo stages CUDA tensors
through the host. Scaling is measured with one rank on each of several
cards.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def paths(rank, device):
    import numpy as np
    import torch

    from accelerated_features_tpu_torch.models.lighterglue import \
        init_lighterglue_params
    from accelerated_features_tpu_torch.models.params import (
        fold_batchnorm, init_xfeat_params, params_from_jax)
    from accelerated_features_tpu_torch.parallel import distributed
    from accelerated_features_tpu_torch.parallel.ba import \
        bundle_adjust_point_sharded
    from accelerated_features_tpu_torch.parallel.lighterglue_sp import \
        lighterglue_forward_sp
    from accelerated_features_tpu_torch.parallel.matching import (
        mnn_match_sp, sharded_detect_and_compute)
    from accelerated_features_tpu_torch.sfm.ba import BAProblem
    from accelerated_features_tpu_torch.train import optim
    from accelerated_features_tpu_torch.train.trainer import (
        TrainConfig, init_train_state, make_sharded_train_step)

    n = torch.distributed.get_world_size()
    model = 2 if n % 2 == 0 else 1
    mesh = distributed.make_pod_mesh(model=model)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    rng = np.random.default_rng(0)
    say = print if distributed.is_primary() else (lambda *a, **k: None)
    say(f"mesh {mesh.shape} over {n} ranks on {device}")

    def timed(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        params = optim.tree_map(lambda t: t.to(dev), params_from_jax(
            fold_batchnorm(init_xfeat_params())))
        images = torch.from_numpy(rng.uniform(0, 1, (
            2 * mesh.size("data"), 96, 128, 1)).astype(np.float32)).to(dev)
        out, ms = timed(lambda: sharded_detect_and_compute(
            mesh, params, images, top_k=256, detection_threshold=0.012))
        say(f"dp extraction: keypoints {tuple(out['keypoints'].shape)}, "
            f"{ms:.1f} ms")

        d1 = torch.from_numpy(rng.normal(size=(512, 64)).astype(
            np.float32)).to(dev)
        d2 = torch.from_numpy(rng.normal(size=(1024, 64)).astype(
            np.float32)).to(dev)
        (_, mask), ms = timed(lambda: mnn_match_sp(mesh, d1, d2))
        say(f"sp MNN: {int(mask.sum())} mutual matches, {ms:.1f} ms")

        lg = optim.tree_map(lambda t: t.to(dev), init_lighterglue_params(
            torch.Generator().manual_seed(1)))
        size = torch.tensor([[640.0, 480.0]], device=dev)
        k = torch.from_numpy(rng.uniform(0, 600, (2, 1, 256, 2)).astype(
            np.float32)).to(dev)
        f = torch.from_numpy(rng.normal(size=(2, 1, 256, 64)).astype(
            np.float32)).to(dev)
        (m0, _), ms = timed(lambda: lighterglue_forward_sp(
            mesh, lg, k[0], k[1], f[0], f[1], size, size))
        say(f"sp LighterGlue: {int((m0 >= 0).sum())} matches, {ms:.1f} ms")

        n_cams, n_pts = 6, 160
        pts = (rng.uniform(-1, 1, (n_pts, 3)) + [0, 0, 5]).astype(
            np.float32)
        cams = np.zeros((n_cams, 6), np.float32)
        cams[:, 3] = np.linspace(0, 0.5, n_cams)
        oc = np.repeat(np.arange(n_cams), n_pts)
        op = np.tile(np.arange(n_pts), n_cams)
        uv = (pts[op, :2] / pts[op, 2:] * 100.0 + 64.0).astype(np.float32)
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        prob = BAProblem(t(cams), t(pts + np.float32(0.01)), t(np.array(
            [[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)),
            t(oc), t(op), t(uv), t(np.ones(len(oc), bool)))
        (_, info), ms = timed(lambda: bundle_adjust_point_sharded(
            prob, mesh, iters=3, cg_iters=20))
        say(f"point-sharded BA: cost {float(info['initial_cost']):.4f} -> "
            f"{float(info['final_cost']):.4f}, {ms:.1f} ms")

    cfg = TrainConfig(use_distill=False, use_kp_position=True)
    B = 2 * mesh.size("data")
    batch = {"image0": rng.uniform(0, 1, (B, 64, 64, 1)),
             "image1": rng.uniform(0, 1, (B, 64, 64, 1)),
             "corrs": rng.integers(0, 8, (B, 32, 4)),
             "corr_valid": np.ones((B, 32), bool),
             "corrs_full": rng.uniform(4, 60, (B, 32, 4)),
             "corr_full_valid": np.ones((B, 32), bool)}
    batch = {k: torch.from_numpy(v).to(dev, torch.bool if v.dtype == bool
                                       else torch.float32)
             for k, v in batch.items()}
    state = init_train_state(optim.tree_map(
        lambda t: t.to(dev), params_from_jax(init_xfeat_params())), cfg)
    step_fn, state, shard_batch = make_sharded_train_step(mesh, state,
                                                          batch, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    (state, metrics), ms = timed(lambda: step_fn(state, shard_batch(batch),
                                                 gen))
    say(f"dp x tp train step: loss {float(metrics['loss_total']):.4f}, "
        f"{ms:.1f} ms")


def _cpu_rank(rank):
    paths(rank, "cpu")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu_ranks", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU instead")
    args = ap.parse_args()
    if args.cpu_ranks:
        from accelerated_features_tpu_torch.parallel.dryrun import run_ranks
        run_ranks(_cpu_rank, args.cpu_ranks, device="cpu", timeout=600.0,
                  threads=2)
        return
    from accelerated_features_tpu_torch.parallel import distributed
    if not distributed.initialize(device="cuda"):
        raise SystemExit("run under torchrun (one rank a card), or pass "
                         "--cpu_ranks N")
    try:
        paths(int(os.environ.get("RANK", "0")), "cuda")
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
