"""LighterGlue matcher training of the port: the JAX package's
`train/lighterglue_run.py` in torch.

A step: a synthetic warped pair (`augmentation.make_pair`) -> the frozen
extractor on both views (`ops.extraction.detect_and_compute` under
`torch.no_grad()`: kernels A and B on the card) -> the ground-truth
assignment from the analytic warp (view-2 keypoints mapped into view 1,
mutual nearest within `match_px` matched, farther than `unmatch_px` from
every counterpart unmatchable) -> the assignment NLL through
`lighterglue_forward` (every attention kernel D, forward and backward) ->
Adam at 1e-4 (`optim.adam`, optax's arithmetic and state layout).

    python -m accelerated_features_tpu_torch.train.lighterglue_run \\
        --synthetic_root_path DIR_OF_IMAGES --ckpt_save_path CKPT_DIR \\
        --xfeat_weights artifacts/run_md_ckpt13250.npz [--device cpu]

Checkpoints are the JAX package's `.npz` train states (either package
resumes the other's) and load into `XFeat.set_lighterglue(weights=...)`,
a file or the checkpoint directory.
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import Any, Dict, List, Optional

import torch

from . import optim


def init_lg_train_state(params: Dict[str, Any],
                        opt: optim.GradientTransformation) -> Dict[str, Any]:
    dev = optim.tree_leaves(params)[0].device
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def build_lg_batch(xfeat_params: Dict[str, Any], pair: Dict[str, Any], cfg,
                   top_k: int = 512, detection_threshold: float = 0.05,
                   match_px: float = 3.0, unmatch_px: float = 5.0,
                   n_gt: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   priority: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Keypoints of both views of an augmented pair and the ground-truth
    assignment from the analytic warp: the batch `lighterglue_loss`
    takes. Over `n_gt` matches, the kept ones are a uniform draw (from
    `generator`, or the caller's `priority` (B, K) uniforms); without
    either, the first in keypoint order."""
    from ..ops.extraction import detect_and_compute
    from .augmentation import view2_to_view1

    g1 = pair["view1"].mean(dim=-1, keepdim=True)
    g2 = pair["view2"].mean(dim=-1, keepdim=True)
    o0 = detect_and_compute(xfeat_params, g1, top_k=top_k,
                            detection_threshold=detection_threshold)
    o1 = detect_and_compute(xfeat_params, g2, top_k=top_k,
                            detection_threshold=detection_threshold)
    k0, k1 = o0["keypoints"], o1["keypoints"]
    v0, v1 = o0["valid"], o1["valid"]
    k1_in1 = view2_to_view1(k1, pair["H1"], pair["H2"], cfg, pair["tps2"])

    d2 = ((k0[:, :, None, :] - k1_in1[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(v0[:, :, None] & v1[:, None, :], d2, float("inf"))
    dmin0, j_star = d2.min(dim=2)
    dmin1, i_star = d2.min(dim=1)
    K = k0.shape[1]
    ar = torch.arange(K, device=k0.device)[None, :]
    mutual = torch.gather(i_star, 1, j_star) == ar
    matched = mutual & (dmin0 < match_px ** 2) & v0

    S = n_gt or K
    if priority is None and generator is not None:
        priority = torch.rand(matched.shape, generator=generator,
                              device=matched.device)
    if priority is not None:
        order = torch.argsort(torch.where(matched, priority, 2.0), dim=1,
                              stable=True)
    else:
        order = torch.argsort((~matched).to(torch.uint8), dim=1, stable=True)
    w_out, h_out = cfg.out_resolution
    size = torch.tensor([float(w_out), float(h_out)],
                        device=k0.device).expand(k0.shape[0], 2)
    return {
        "kpts0": k0, "kpts1": k1,
        "descs0": o0["descriptors"], "descs1": o1["descriptors"],
        "size0": size, "size1": size, "mask0": v0, "mask1": v1,
        "gt_idx0": order[:, :S],
        "gt_idx1": torch.gather(j_star, 1, order)[:, :S],
        "gt_valid": torch.gather(matched, 1, order)[:, :S],
        "unmatched0": v0 & (dmin0 > unmatch_px ** 2),
        "unmatched1": v1 & (dmin1 > unmatch_px ** 2),
    }


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """(loss, metrics, grads) of `lighterglue_loss`; grads a tree shaped
    like params (zero where a leaf is unused, e.g. token_confidence)."""
    from .lighterglue_loss import lighterglue_loss
    return optim.value_and_grad(lambda p: lighterglue_loss(p, batch),
                                params)


def lg_train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  opt: optim.GradientTransformation):
    """One Adam step on the matcher. Returns (new state, loss, metrics)."""
    loss, metrics, grads = loss_and_grads(state["params"], batch)
    with torch.no_grad():
        updates, opt_state = opt.update(grads, state["opt_state"],
                                        state["params"])
        params = optim.apply_updates(state["params"], updates)
    return ({"params": params, "opt_state": opt_state,
             "step": state["step"] + 1}, loss, metrics)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="LighterGlue training")
    ap.add_argument("--synthetic_root_path", type=str, required=True)
    ap.add_argument("--ckpt_save_path", type=str, required=True)
    ap.add_argument("--xfeat_weights", type=str, default=None,
                    help="frozen extractor weights (.npz or a training "
                         "checkpoint directory); None = random init "
                         "(smoke only)")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--top_k", type=int, default=512)
    ap.add_argument("--n_steps", type=int, default=50_000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--training_res", type=lambda s: tuple(
        map(int, s.split(","))), default=(800, 608))
    ap.add_argument("--detection_threshold", type=float, default=None,
                    help="default 0.012 for a random extractor, 0.05 "
                         "trained")
    ap.add_argument("--save_ckpt_every", type=int, default=1000)
    ap.add_argument("--difficulty", type=float, default=0.10)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> List[Dict[str, float]]:
    """Train; returns one {step, loss, match_acc, wall_s} a step."""
    from ..models.lighterglue import DEFAULT_CONF, init_lighterglue_params
    from ..models.params import load_params
    from ..ops.resize import to_unit_float
    from ..utils.checkpoint import resume_or_init, save_checkpoint
    from .augmentation import AugConfig, make_pair
    from .megadepth import ImageFolderSource

    args = parse_args(argv)
    dev = torch.device(args.device)
    thr = args.detection_threshold
    if thr is None:
        thr = 0.05 if args.xfeat_weights else 0.012
    xfeat_params = optim.tree_map(lambda t: t.to(dev),
                                  load_params(args.xfeat_weights))
    cfg = AugConfig(warp_resolution=args.training_res,
                    out_resolution=args.training_res)
    source = ImageFolderSource(args.synthetic_root_path, args.training_res)

    params = optim.tree_map(lambda t: t.to(dev), init_lighterglue_params(
        torch.Generator().manual_seed(0), DEFAULT_CONF))
    opt = optim.adam(args.lr)
    state, resumed = resume_or_init(args.ckpt_save_path,
                                    init_lg_train_state(params, opt))
    start = int(state["step"])
    if resumed:
        print(f"[resume] from step {start}")
    pool = torch.from_numpy(source.pool_u8()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(start + 1)

    # on SIGTERM/SIGINT: checkpoint at the next step boundary and exit;
    # the caller's handlers come back afterwards
    stop = {"flag": False}

    def request_stop(signum, frame):
        stop["flag"] = True
        print(f"[signal {signum}] checkpoint-and-exit requested", flush=True)

    prev_term = signal.signal(signal.SIGTERM, request_stop)
    prev_int = signal.signal(signal.SIGINT, request_stop)
    history: List[Dict[str, float]] = []
    try:
        for i in range(start, args.n_steps):
            t0 = time.perf_counter()
            idx, changed = source.sample_indices(args.batch_size)
            if changed:
                pool = torch.from_numpy(source.pool_u8()).to(dev)
            images = to_unit_float(pool[torch.from_numpy(idx).to(dev)])
            pair = make_pair(gen, images, cfg, args.difficulty, tps_prob=0.7)
            batch = build_lg_batch(xfeat_params, pair, cfg, args.top_k, thr,
                                   generator=gen)
            state, loss, metrics = lg_train_step(state, batch, opt)
            loss_f = float(loss)  # waits for the step
            history.append({"step": i + 1, "loss": loss_f,
                            "match_acc": float(metrics["match_acc"]),
                            "wall_s": time.perf_counter() - t0})
            if (i + 1) % args.save_ckpt_every == 0 or stop["flag"]:
                path = save_checkpoint(args.ckpt_save_path, state, i + 1)
                print(f"[ckpt] step {i + 1} -> {path}")
            if stop["flag"]:
                print(f"[preempt] state saved at step {i + 1}; exiting "
                      "(resume with the same --ckpt_save_path)", flush=True)
                return history
            if (i + 1) % 10 == 0:
                n_gt = float(batch["gt_valid"].sum()) / args.batch_size
                print(f"step {i + 1} loss {loss_f:.4f} match_acc "
                      f"{history[-1]['match_acc']:.3f} gt/pair {n_gt:.0f} "
                      f"({history[-1]['wall_s']:.3f} s)", flush=True)
        final = int(state["step"])
        if final > start and final % args.save_ckpt_every != 0:
            save_checkpoint(args.ckpt_save_path, state, final)
        print("done")
        return history
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


if __name__ == "__main__":
    main()
