"""XFeat training entry point of the port: the JAX package's
`train/run.py` in torch, on one device.

The recipe of the reference: each batch 40% synthetic pairs (homography
and TPS warps of an image folder, `augmentation.make_pair`, /8-grid
ground truth from the analytic warp) and 60% depth-supervised pairs;
Adam 3e-4 with a staircase decay; the losses of `train/losses.py`.
Checkpoints hold the whole state and resume (`utils/checkpoint.py`, the
JAX package's `.npz` layout); SIGTERM or SIGINT saves at the next step
and exits.

The depth-supervised pairs are rendered (`train/render.render_scene_views`
on textures from the image folder; once, then sampled) and go through
`warp.spvs_coarse` and `warp.spvs_full`. The MegaDepth reader of the JAX
package needs HDF5 depth and cv2, which the port does not count on:
`--megadepth_root_path` raises. `--dry_run` trains on one fixed random
batch. Without `--distill_teacher` the keypoint head learns from
`keypoint_position_loss` (teacher-free).

    python -m accelerated_features_tpu_torch.train.run \\
        --synthetic_root_path DIR_OF_IMAGES --ckpt_save_path CKPT_DIR \\
        [--dry_run] [--device cpu]
"""

from __future__ import annotations

import argparse
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import optim
from .augmentation import (AugConfig, make_pair, pair_correspondences,
                           pair_correspondences_full)
from .megadepth import ImageFolderSource
from .trainer import TrainConfig, init_train_state, train_step
from .warp import corr_to_fixed, spvs_coarse, spvs_full


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="XFeat training")
    ap.add_argument("--megadepth_root_path", type=str, default=None,
                    help="not available in the port (no HDF5 depth "
                         "reader); depth pairs are rendered instead")
    ap.add_argument("--synthetic_root_path", type=str, default=None)
    ap.add_argument("--ckpt_save_path", type=str, required=True)
    ap.add_argument("--training_type", type=str, default="xfeat_default",
                    choices=["xfeat_default", "xfeat_synthetic",
                             "xfeat_megadepth"])
    ap.add_argument("--batch_size", type=int, default=10)
    ap.add_argument("--n_steps", type=int, default=160_000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma_steplr", type=float, default=0.5)
    ap.add_argument("--training_res", type=lambda s: tuple(
        map(int, s.split(","))), default=(800, 608))
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--save_ckpt_every", type=int, default=500)
    ap.add_argument("--max_corrs", type=int, default=1024,
                    help="fixed correspondence budget per pair")
    ap.add_argument("--distill_teacher", type=str, default=None,
                    help="weights (.npz or a checkpoint directory) of a "
                         "teacher XFeat whose keypoints supervise the "
                         "keypoint head")
    ap.add_argument("--rendered_pairs", type=int, default=64,
                    help="depth-supervised pairs rendered at start and "
                         "sampled from")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _gray(images: torch.Tensor) -> torch.Tensor:
    return images.mean(dim=-1, keepdim=True)


class SyntheticBatcher:
    """Synthetic warped pairs of an image pool kept on the device: two
    augmented views, the /8 ground truth packed to `max_corrs`, and the
    jittered full-resolution set of the teacher-free keypoint loss."""

    def __init__(self, source: ImageFolderSource, cfg: AugConfig,
                 batch_size: int, max_corrs: int, device: torch.device,
                 difficulty: float = 0.10, seed: int = 0):
        self.source, self.cfg = source, cfg
        self.batch_size, self.max_corrs = batch_size, max_corrs
        self.difficulty, self.device = difficulty, device
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.pool = torch.from_numpy(source.pool_u8()).to(device)

    def next(self) -> Dict[str, torch.Tensor]:
        idx, changed = self.source.sample_indices(self.batch_size)
        if changed:
            self.pool = torch.from_numpy(self.source.pool_u8()).to(
                self.device)
        images = self.pool[torch.from_numpy(idx).to(self.device)].float() \
            / 255.0
        return synthetic_batch(self.gen, images, self.cfg, self.max_corrs,
                               self.difficulty)


def synthetic_batch(gen: Optional[torch.Generator], images: torch.Tensor,
                    cfg: AugConfig, max_corrs: int,
                    difficulty: float = 0.10) -> Dict[str, torch.Tensor]:
    """A training batch of synthetic pairs of (B,H,W,3) images in [0,1]."""
    pair = make_pair(gen, images, cfg, difficulty, tps_prob=0.7)
    corrs, mask = pair_correspondences(pair, cfg)
    corrs, mask = corr_to_fixed(corrs, mask, max_corrs, gen)
    cf, cf_mask = pair_correspondences_full(pair, cfg, gen)
    return {"image0": _gray(pair["view1"]), "image1": _gray(pair["view2"]),
            "corrs": corrs, "corr_valid": mask, "corrs_full": cf,
            "corr_full_valid": cf_mask}


def render_depth_pairs(textures: List[np.ndarray], n_pairs: int,
                       res, seed: int = 0) -> Dict[str, np.ndarray]:
    """`n_pairs` two-view scenes rendered at res (W, H): uint8 images
    (N,2,H,W,3), depths (N,2,H,W), K (N,3,3), T_0to1 and T_1to0 (N,4,4)."""
    from .render import render_scene_views
    rng = np.random.default_rng(seed)
    W, H = res
    images, depths, Ks, T01 = [], [], [], []
    for _ in range(n_pairs):
        views = render_scene_views(rng, textures, 2, W, H)
        images.append(np.stack(views["images"]))
        depths.append(np.stack(views["depths"]))
        Ks.append(views["Ks"][0])
        T01.append(views["poses"][1] @ np.linalg.inv(views["poses"][0]))
    T01 = np.stack(T01).astype(np.float32)
    return {"images": np.stack(images), "depths": np.stack(depths),
            "K": np.stack(Ks).astype(np.float32), "T_0to1": T01,
            "T_1to0": np.linalg.inv(T01).astype(np.float32)}


def depth_batch(pairs: Dict[str, torch.Tensor], idx: torch.Tensor,
                max_corrs: int, gen: Optional[torch.Generator]
                ) -> Dict[str, torch.Tensor]:
    """A training batch of the depth-supervised pairs `idx` (on the
    device): spvs_coarse packed to `max_corrs`, and spvs_full."""
    imgs = pairs["images"][idx].float() / 255.0
    d = {"image0": imgs[:, 0], "image1": imgs[:, 1],
         "depth0": pairs["depths"][idx, 0], "depth1": pairs["depths"][idx, 1],
         "K0": pairs["K"][idx], "K1": pairs["K"][idx],
         "T_0to1": pairs["T_0to1"][idx], "T_1to0": pairs["T_1to0"][idx]}
    corrs, mask = spvs_coarse(d, 8)
    corrs, mask = corr_to_fixed(corrs, mask, max_corrs, gen)
    cf, cf_mask = spvs_full(d, gen, 8)
    return {"image0": _gray(d["image0"]), "image1": _gray(d["image1"]),
            "corrs": corrs, "corr_valid": mask, "corrs_full": cf,
            "corr_full_valid": cf_mask}


class RenderedDepthBatcher:
    """Depth-supervised pairs rendered once (`render_depth_pairs`) and kept
    on the device; a batch draws `batch_size` of them."""

    def __init__(self, textures: List[np.ndarray], n_pairs: int, res,
                 batch_size: int, max_corrs: int, device: torch.device,
                 seed: int = 0):
        rendered = render_depth_pairs(textures, n_pairs, res, seed)
        self.pairs = {k: torch.from_numpy(v).to(device)
                      for k, v in rendered.items()}
        self.batch_size, self.max_corrs = batch_size, max_corrs
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.device = device

    def next(self) -> Dict[str, torch.Tensor]:
        idx = torch.from_numpy(self.rng.integers(
            0, len(self.pairs["K"]), self.batch_size)).to(self.device)
        return depth_batch(self.pairs, idx, self.max_corrs, self.gen)


def dry_run_batch(batch_size: int, res, max_corrs: int,
                  device: torch.device = torch.device("cpu")
                  ) -> Dict[str, torch.Tensor]:
    """A fixed random batch (numpy seed 0), the JAX package's."""
    rng = np.random.default_rng(0)
    W, H = res
    b = {
        "image0": rng.uniform(0, 1, (batch_size, H, W, 1)),
        "image1": rng.uniform(0, 1, (batch_size, H, W, 1)),
        "corrs": rng.integers(2, min(H, W) // 8 - 2,
                              (batch_size, max_corrs, 4)),
        "corr_valid": np.ones((batch_size, max_corrs), bool),
        "corrs_full": rng.uniform(16, min(H, W) - 16,
                                  (batch_size, max_corrs, 4)),
        "corr_full_valid": np.ones((batch_size, max_corrs), bool),
    }
    return {k: torch.tensor(v, dtype=torch.bool if v.dtype == bool
                            else torch.float32, device=device)
            for k, v in b.items()}


def concat_batches(parts: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def main(argv=None) -> List[Dict[str, float]]:
    """Train; returns one {step, loss_total, ..., wall_s} a step run."""
    from ..models.params import init_xfeat_params, params_from_jax
    from ..utils.checkpoint import resume_or_init, save_checkpoint
    from ..utils.imageio import load_textures

    args = parse_args(argv)
    dev = torch.device(args.device)
    if args.megadepth_root_path:
        raise NotImplementedError(
            "--megadepth_root_path: the port has no MegaDepth depth reader "
            "(the JAX package's reads HDF5 depth maps with h5py and resizes "
            "with cv2); the depth-supervised pairs are rendered instead "
            "from --synthetic_root_path")
    teacher_fn = None
    if args.distill_teacher:
        from .utils import make_xfeat_teacher
        teacher_fn = make_xfeat_teacher(args.distill_teacher)
    cfg = TrainConfig(lr=args.lr, lr_gamma=args.gamma_steplr,
                      use_distill=teacher_fn is not None,
                      use_kp_position=teacher_fn is None)

    params = optim.tree_map(lambda t: t.to(dev),
                            params_from_jax(init_xfeat_params()))
    state, resumed = resume_or_init(args.ckpt_save_path,
                                    init_train_state(params, cfg))
    start = int(state["step"])
    if resumed:
        print(f"[resume] from step {start}")

    use_synth = args.training_type in ("xfeat_default", "xfeat_synthetic")
    use_md = args.training_type in ("xfeat_default", "xfeat_megadepth")
    split = args.training_type == "xfeat_default"
    bs_synth = int(args.batch_size * 0.4) if split else args.batch_size
    bs_md = int(args.batch_size * 0.6) if split else args.batch_size
    if (use_synth and bs_synth < 1) or (use_md and bs_md < 1):
        raise SystemExit(f"--batch_size {args.batch_size} leaves an empty "
                         f"sub-batch under the 40/60 split of "
                         f"'{args.training_type}'; use batch_size >= 3")
    if not args.dry_run and not args.synthetic_root_path:
        raise SystemExit(f"--training_type {args.training_type} needs "
                         "--synthetic_root_path (images, and the textures "
                         "of the rendered depth pairs) or --dry_run")

    if args.dry_run:
        fixed = dry_run_batch(bs_synth + bs_md if split else args.batch_size,
                              args.training_res, args.max_corrs, dev)
        get_batch = lambda: fixed  # noqa: E731
        n_steps = min(args.n_steps, 10)
    else:
        parts = []
        if use_synth:
            aug = AugConfig(warp_resolution=args.training_res,
                            out_resolution=args.training_res)
            source = ImageFolderSource(args.synthetic_root_path,
                                       args.training_res)
            parts.append(SyntheticBatcher(source, aug, bs_synth,
                                          args.max_corrs, dev, seed=start))
        if use_md:
            textures = load_textures(args.synthetic_root_path, 16,
                                     np.random.default_rng(0))
            parts.append(RenderedDepthBatcher(
                textures, args.rendered_pairs, args.training_res, bs_md,
                args.max_corrs, dev, seed=start))
        get_batch = lambda: concat_batches([p.next() for p in parts])  # noqa
        n_steps = args.n_steps

    def prepare(batch):
        if teacher_fn is not None:
            batch = dict(batch)
            batch["distill_labels0"] = teacher_fn(batch["image0"])
            batch["distill_labels1"] = teacher_fn(batch["image1"])
        return batch

    stop = {"flag": False}

    def request_stop(signum, frame):
        stop["flag"] = True
        print(f"[signal {signum}] checkpoint-and-exit requested", flush=True)

    prev_term = signal.signal(signal.SIGTERM, request_stop)
    prev_int = signal.signal(signal.SIGINT, request_stop)
    gen = torch.Generator(device=dev).manual_seed(start + 7)
    history: List[Dict[str, float]] = []
    try:
        for i in range(start, n_steps):
            t0 = time.perf_counter()
            batch = prepare(get_batch())
            # skip a batch with a pair of < 30 correspondences (the
            # reference's corrupted-batch rule)
            if not args.dry_run and \
                    bool((batch["corr_valid"].sum(-1) < 30).any()):
                continue
            state, metrics = train_step(state, batch, gen, cfg)
            m = {k: float(v) for k, v in metrics.items()}
            m.update(step=i + 1, wall_s=time.perf_counter() - t0)
            history.append(m)
            if (i + 1) % args.save_ckpt_every == 0 or stop["flag"]:
                path = save_checkpoint(args.ckpt_save_path, state, i + 1)
                print(f"[ckpt] step {i + 1} -> {path}")
            if stop["flag"]:
                print(f"[preempt] state saved at step {i + 1}; exiting "
                      "(resume with the same --ckpt_save_path)", flush=True)
                return history
            if (i + 1) % 10 == 0 or args.dry_run:
                print(f"step {i + 1} loss {m['loss_total']:.4f} coarse "
                      f"{m['loss_coarse']:.3f} fine {m['loss_fine']:.3f} "
                      f"rel {m['loss_reliability']:.3f} "
                      f"({m['wall_s']:.3f} s)", flush=True)
        print("done")
        return history
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        signal.signal(signal.SIGINT, prev_int)


if __name__ == "__main__":
    main()
