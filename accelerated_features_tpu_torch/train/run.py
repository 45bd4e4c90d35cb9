"""XFeat training entry point of the port: the JAX package's
`train/run.py` in torch, on one card or over a mesh of ranks.

The recipe of the reference: each batch 40% synthetic pairs (homography
and TPS warps of an image folder, `augmentation.make_pair`, /8-grid
ground truth from the analytic warp) and 60% depth-supervised pairs;
Adam 3e-4 with a staircase decay; the losses of `train/losses.py`.
Checkpoints hold the whole state and resume (`utils/checkpoint.py`, the
JAX package's `.npz` layout); SIGTERM or SIGINT saves at the next step
and exits.

Depth-supervised pairs come from a MegaDepth-layout dataset
(`--megadepth_root_path`, `train/megadepth.py`: HDF5 depth and PNG or
JPEG images read without h5py or cv2), streamed by the host loader
(`MegaDepthBatcher`) or, with `--md_resident`, held whole on the card
(`ResidentMegaDepthBatcher`, depths in bfloat16); the ground truth
(`warp.spvs_coarse`, `warp.spvs_full`) runs on the card. Without a
MegaDepth root they are rendered (`train/render.render_scene_views` on
textures from the image folder; once, then sampled). Batches are made by
a producer thread (`Prefetcher`, queue depth 2) on a CUDA stream of its
own. `--dry_run` trains on one fixed random batch. Without
`--distill_teacher` the keypoint head learns from `keypoint_position_loss`
(teacher-free).

Under `torchrun` (one rank a card, `parallel/distributed.py`) the step is
`trainer.make_sharded_train_step` over a (data, model) mesh: `--mesh DxM`,
or by default the largest data axis that divides the batch and the rank
count. Every rank makes the global batch from the same seeds and keeps
its share; rank 0 alone prints and writes checkpoints.

    python -m accelerated_features_tpu_torch.train.run \\
        --synthetic_root_path DIR_OF_IMAGES --megadepth_root_path MD_ROOT \\
        --ckpt_save_path CKPT_DIR [--md_resident] [--dry_run] [--device cpu]
    torchrun --nproc_per_node 4 -m accelerated_features_tpu_torch.train.run \\
        --ckpt_save_path CKPT_DIR --dry_run --mesh 2x2
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import optim
from .augmentation import (AugConfig, make_pair, pair_correspondences,
                           pair_correspondences_full)
from .megadepth import ImageFolderSource, MegaDepthLoader, load_all_views
from .trainer import (TrainConfig, gather_state, init_train_state,
                      make_sharded_train_step, train_step)
from .warp import corr_to_fixed, spvs_coarse, spvs_full


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="XFeat training")
    ap.add_argument("--megadepth_root_path", type=str, default=None,
                    help="a MegaDepth-layout dataset; without it the depth "
                         "pairs are rendered from --synthetic_root_path")
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
    ap.add_argument("--md_resident", action="store_true",
                    help="hold the whole MegaDepth-layout dataset on the "
                         "card (uint8 images, bfloat16 depths) and move "
                         "only pair indices a step; for datasets that fit")
    ap.add_argument("--mesh", type=lambda s: tuple(map(int, s.split("x"))),
                    default=None, help="data x model mesh, e.g. 2x2")
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


def depth_ground_truth(d: Dict[str, torch.Tensor], max_corrs: int,
                       gen: Optional[torch.Generator],
                       priority: Optional[torch.Tensor] = None,
                       jitter: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """A training batch of depth-supervised pairs `d` (image0/1 (B,H,W,1)
    in [0,1], depth0/1, K0/1, T_0to1, T_1to0, scale0/1): spvs_coarse
    packed to `max_corrs` (the first draw of `gen`, or `priority`) and
    spvs_full (the second, or `jitter`)."""
    corrs, mask = spvs_coarse(d, 8)
    corrs, mask = corr_to_fixed(corrs, mask, max_corrs, gen, priority)
    cf, cf_mask = spvs_full(d, gen, 8, jitter)
    return {"image0": _gray(d["image0"]), "image1": _gray(d["image1"]),
            "corrs": corrs, "corr_valid": mask, "corrs_full": cf,
            "corr_full_valid": cf_mask}


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
    return depth_ground_truth(d, max_corrs, gen)


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


class ResidentMegaDepthBatcher:
    """Depth-supervised pairs of a MegaDepth-layout dataset held whole on
    the device (`megadepth.load_all_views`): a step moves only pair
    indices from the host. Depths are held in bfloat16 (half the largest
    buffer; its 2^-8 relative rounding moves a warped point by at most
    that share of its disparity) and cast to float32 per batch, as in the
    JAX package. Pair indices come from numpy (`seed`), the ground
    truth's draws from a generator on the device (`seed` + 2)."""

    def __init__(self, megadepth_root: str, batch_size: int, image_size,
                 max_corrs: int, device: torch.device, seed: int = 0,
                 verbose: bool = True):
        views = load_all_views(megadepth_root, image_size)
        if verbose:
            n_bytes = sum(v.nbytes for v in views.values())
            print(f"[md-resident] {views['images'].shape[0]} views, "
                  f"{len(views['pair_i0'])} pairs, {n_bytes / 1e9:.2f} GB "
                  f"-> {device}", flush=True)
        self.n_pairs = len(views["pair_i0"])
        self.batch_size, self.max_corrs = batch_size, max_corrs
        self.device = device
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device).manual_seed(seed + 2)
        self.views = {k: torch.from_numpy(v).to(device) for k, v in
                      views.items()}
        self.views["depths"] = self.views["depths"].to(torch.bfloat16)

    def pairs(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pairs `idx` (on the device) as the depth ground truth takes
        them."""
        v = self.views
        i0, i1 = v["pair_i0"][idx].long(), v["pair_i1"][idx].long()
        return {"image0": v["images"][i0].float() / 255.0,
                "image1": v["images"][i1].float() / 255.0,
                "depth0": v["depths"][i0].float(),
                "depth1": v["depths"][i1].float(),
                "K0": v["Ks"][i0], "K1": v["Ks"][i1],
                "T_0to1": v["T_0to1"][idx], "T_1to0": v["T_1to0"][idx],
                "scale0": v["scales"][i0], "scale1": v["scales"][i1]}

    def next(self) -> Dict[str, torch.Tensor]:
        idx = torch.from_numpy(self.rng.integers(
            0, self.n_pairs, self.batch_size)).to(self.device)
        return depth_ground_truth(self.pairs(idx), self.max_corrs, self.gen)


class MegaDepthBatcher:
    """Depth-supervised pairs streamed by the host loader
    (`megadepth.MegaDepthLoader`), the ground truth on the device (draws
    from a generator there, `seed`)."""

    def __init__(self, loader: MegaDepthLoader, max_corrs: int,
                 device: torch.device, seed: int = 1):
        self.it = loader.infinite()
        self.max_corrs, self.device = max_corrs, device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def pairs(self, items: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in items.items()}

    def next(self) -> Dict[str, torch.Tensor]:
        return depth_ground_truth(self.pairs(next(self.it)), self.max_corrs,
                                  self.gen)


class Prefetcher:
    """A producer thread for `fn()` (a batch), queue depth 2: host work
    (disk reads, decoding, the loader's numpy) and the launch of the
    batch's device work overlap the training step. An exception in the
    producer is raised by the call that would have returned its batch;
    `stop()` ends the thread.

    On CUDA the producer runs on a stream of its own and records an event
    after each batch; the consumer's stream waits on that event before the
    step reads the batch, and every tensor of the batch is
    `record_stream`ed on the consumer's stream, so the allocator does not
    hand its memory back to the producer while the step still reads it."""

    def __init__(self, fn: Callable[[], Dict[str, torch.Tensor]],
                 device: torch.device, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.device = device
        cuda = device.type == "cuda"
        index = (device.index if device.index is not None
                 else torch.cuda.current_device()) if cuda else None
        self._stream = torch.cuda.Stream(index) if cuda else None

        def put(item):
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                if cuda:
                    torch.cuda.set_device(index)
                while not self._stop.is_set():
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            batch = fn()
                            done = torch.cuda.Event()
                            done.record(self._stream)
                    else:
                        batch, done = fn(), None
                    put((batch, done, None))
            except BaseException as e:  # raised in the consumer
                put((None, None, e))
        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="batch-prefetch")
        self._thread.start()

    def __call__(self) -> Dict[str, torch.Tensor]:
        while True:
            try:
                batch, done, err = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("the prefetch thread ended without "
                                       "a batch") from None
        if err is not None:
            raise err
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


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


def _mesh_shape(args, eff_batch: int, n_ranks: int):
    """--mesh, or the largest data axis that divides the batch and the
    rank count (the JAX package's rule)."""
    if args.mesh:
        return args.mesh
    return (max(d for d in range(1, n_ranks + 1)
                if eff_batch % d == 0 and n_ranks % d == 0), 1)


def _make_writer(ckpt_dir: str):
    """A tensorboard writer, or None when it cannot be made (no
    `tensorboard` package), as in the JAX package."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(os.path.join(ckpt_dir, "logdir"))
    except Exception:
        return None


def _sources(args, dev, start, use_synth, use_md, bs_synth, bs_md, primary):
    """The batchers of the recipe: synthetic pairs, then depth pairs."""
    from ..utils.imageio import load_textures
    parts = []
    if use_synth:
        aug = AugConfig(warp_resolution=args.training_res,
                        out_resolution=args.training_res)
        source = ImageFolderSource(args.synthetic_root_path,
                                   args.training_res)
        parts.append(SyntheticBatcher(source, aug, bs_synth, args.max_corrs,
                                      dev, seed=start))
    if use_md and args.megadepth_root_path:
        if args.md_resident:
            parts.append(ResidentMegaDepthBatcher(
                args.megadepth_root_path, bs_md, args.training_res,
                args.max_corrs, dev, seed=start, verbose=primary))
        else:
            parts.append(MegaDepthBatcher(
                MegaDepthLoader(args.megadepth_root_path, bs_md,
                                args.training_res, seed=start),
                args.max_corrs, dev, seed=start + 1))
    elif use_md:
        textures = load_textures(args.synthetic_root_path, 16,
                                 np.random.default_rng(0))
        parts.append(RenderedDepthBatcher(
            textures, args.rendered_pairs, args.training_res, bs_md,
            args.max_corrs, dev, seed=start))
    return parts


def main(argv=None) -> List[Dict[str, float]]:
    """Train; returns one {step, loss_total, ..., wall_s} a step run (on
    every rank; empty on a rank outside the mesh)."""
    from ..models.params import init_xfeat_params, params_from_jax
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh, world
    from ..utils.checkpoint import resume_or_init

    args = parse_args(argv)
    distributed.initialize(device=args.device)
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    teacher_fn = None
    if args.distill_teacher:
        from .utils import make_xfeat_teacher
        teacher_fn = make_xfeat_teacher(args.distill_teacher)
    cfg = TrainConfig(lr=args.lr, lr_gamma=args.gamma_steplr,
                      use_distill=teacher_fn is not None,
                      use_kp_position=teacher_fn is None)

    use_synth = args.training_type in ("xfeat_default", "xfeat_synthetic")
    use_md = args.training_type in ("xfeat_default", "xfeat_megadepth")
    split = args.training_type == "xfeat_default"
    bs_synth = int(args.batch_size * 0.4) if split else args.batch_size
    bs_md = int(args.batch_size * 0.6) if split else args.batch_size
    eff_batch = bs_synth + bs_md if split else args.batch_size
    if (use_synth and bs_synth < 1) or (use_md and bs_md < 1):
        raise SystemExit(f"--batch_size {args.batch_size} leaves an empty "
                         f"sub-batch under the 40/60 split of "
                         f"'{args.training_type}'; use batch_size >= 3")
    if not args.dry_run:
        if use_synth and not args.synthetic_root_path:
            raise SystemExit(f"--training_type {args.training_type} needs "
                             "--synthetic_root_path (or pass --dry_run)")
        if use_md and not (args.megadepth_root_path
                           or args.synthetic_root_path):
            raise SystemExit(f"--training_type {args.training_type} needs "
                             "--megadepth_root_path (or the textures of "
                             "rendered depth pairs, --synthetic_root_path, "
                             "or --dry_run)")

    rank, n_ranks = world()
    primary = distributed.is_primary()
    shape = _mesh_shape(args, eff_batch, n_ranks)
    mesh = make_mesh(shape)
    if primary and shape[0] * shape[1] < n_ranks:
        print(f"[mesh] using {shape[0] * shape[1]} of {n_ranks} ranks "
              f"(batch {eff_batch}); pass --mesh to override", flush=True)
    if not mesh.active:
        return []

    params = optim.tree_map(lambda t: t.to(dev),
                            params_from_jax(init_xfeat_params()))
    state, resumed = resume_or_init(args.ckpt_save_path,
                                    init_train_state(params, cfg))
    start = int(state["step"])
    if resumed and primary:
        print(f"[resume] from step {start}")

    if args.dry_run:
        fixed = dry_run_batch(eff_batch, args.training_res, args.max_corrs,
                              dev)
        get_batch = lambda: fixed  # noqa: E731
        n_steps = min(args.n_steps, 10)
    else:
        parts = _sources(args, dev, start, use_synth, use_md, bs_synth,
                         bs_md, primary)
        get_batch = Prefetcher(
            lambda: concat_batches([p.next() for p in parts]), dev)
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

    in_main = threading.current_thread() is threading.main_thread()
    if in_main:
        prev_term = signal.signal(signal.SIGTERM, request_stop)
        prev_int = signal.signal(signal.SIGINT, request_stop)
    try:
        return _train_loop(args, cfg, mesh, state, get_batch, prepare,
                           start, n_steps, stop, dev, primary)
    finally:
        if in_main:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
        if isinstance(get_batch, Prefetcher):
            get_batch.stop()


def _train_loop(args, cfg, mesh, state, get_batch, prepare, start, n_steps,
                stop, dev, primary) -> List[Dict[str, float]]:
    from ..utils.checkpoint import save_checkpoint

    sharded = mesh.size("data") * mesh.size("model") > 1
    if sharded:
        step_fn, state, shard_batch = make_sharded_train_step(
            mesh, state, None, cfg)
    writer = _make_writer(args.ckpt_save_path) if primary else None
    gen = torch.Generator(device=dev).manual_seed(start + 7)
    history: List[Dict[str, float]] = []
    for i in range(start, n_steps):
        t0 = time.perf_counter()
        batch = prepare(get_batch())
        # skip a batch with a pair of < 30 correspondences (the
        # reference's corrupted-batch rule)
        if not args.dry_run and \
                bool((batch["corr_valid"].sum(-1) < 30).any()):
            continue
        if sharded:
            state, metrics = step_fn(state, shard_batch(batch), gen)
        else:
            state, metrics = train_step(state, batch, gen, cfg)
        m = {k: float(v) for k, v in metrics.items()}
        m.update(step=i + 1, wall_s=time.perf_counter() - t0)
        history.append(m)
        if (i + 1) % args.save_ckpt_every == 0 or stop["flag"]:
            whole = gather_state(mesh, state) if sharded else state
            if primary:
                path = save_checkpoint(args.ckpt_save_path, whole, i + 1)
                print(f"[ckpt] step {i + 1} -> {path}")
        if stop["flag"]:
            if primary:
                print(f"[preempt] state saved at step {i + 1}; exiting "
                      "(resume with the same --ckpt_save_path)", flush=True)
            return history
        if primary and ((i + 1) % 10 == 0 or args.dry_run):
            print(f"step {i + 1} loss {m['loss_total']:.4f} coarse "
                  f"{m['loss_coarse']:.3f} fine {m['loss_fine']:.3f} "
                  f"rel {m['loss_reliability']:.3f} "
                  f"({m['wall_s']:.3f} s)", flush=True)
            if writer is not None:
                for k, v in m.items():
                    writer.add_scalar(k, v, i + 1)
    if primary:
        print("done")
    return history


if __name__ == "__main__":
    main()
