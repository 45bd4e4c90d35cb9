"""Training utilities of the port: the JAX package's `train/utils.py` in
torch. Accuracy of descriptor matches, patch crops, and the teacher
interface of the distillation loss: teacher keypoints, precomputed to an
`.npz` or given by any callable, become the fixed-shape (h, w) label maps
of `train.losses.distill_loss`; `make_xfeat_teacher` makes them on the
device with a trained XFeat (under `torch.no_grad()`, so on the card it
runs kernels A and B).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .losses import distill_labels_from_kpts
from .optim import tree_map


def check_accuracy(m1: torch.Tensor, m2: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of rows whose nearest neighbour is the diagonal match,
    masked."""
    sim = m1 @ m2.T
    if valid is not None:
        sim = torch.where(valid[None, :], sim, -1e9)
    correct = sim.argmax(dim=1) == torch.arange(m1.shape[0],
                                                device=m1.device)
    if valid is None:
        return correct.float().mean()
    return (correct & valid).sum() / valid.sum().clamp_min(1)


def crop_patches(maps: torch.Tensor, coords: torch.Tensor, size: int = 7
                 ) -> torch.Tensor:
    """size x size patches of maps (H, W, C) around integer coords (N, 2)
    xy -> (N, size, size, C), zeros outside the map."""
    h, w, c = maps.shape
    half = size // 2
    offs = torch.arange(-half, half + 1, device=maps.device)
    n = coords.shape[0]
    ys = (coords[:, 1, None, None] + offs[None, :, None]).expand(n, size,
                                                                 size).long()
    xs = (coords[:, 0, None, None] + offs[None, None, :]).expand(n, size,
                                                                 size).long()
    inb = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    idx = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)
    out = maps.reshape(h * w, c)[idx.reshape(-1)].reshape(n, size, size, c)
    return out * inb[..., None].to(maps.dtype)


TeacherFn = Callable[[np.ndarray], np.ndarray]  # (H,W,C) in [0,1] -> (N,2)


def _padded(kpts: np.ndarray, max_kpts: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    kpts = np.asarray(kpts, np.float32).reshape(-1, 2)[:max_kpts]
    valid = np.arange(max_kpts) < len(kpts)
    kpts = np.concatenate([kpts, np.zeros((max_kpts - len(kpts), 2),
                                          np.float32)])
    return torch.from_numpy(kpts), torch.from_numpy(valid)


def teacher_labels_for_batch(images: torch.Tensor, teacher: TeacherFn,
                             max_kpts: int = 1024) -> torch.Tensor:
    """Run a host-side teacher on each image of (B, H, W, C) and build the
    (B, h, w) label maps, on the images' device."""
    b, H, W = images.shape[:3]
    out = []
    for i in range(b):
        kpts, valid = _padded(teacher(images[i].cpu().numpy()), max_kpts)
        out.append(distill_labels_from_kpts(kpts, valid, H // 8, W // 8))
    return torch.stack(out).to(images.device)


class PrecomputedTeacher:
    """Teacher keypoints precomputed to an `.npz`, one key an image id
    (`save_teacher_keypoints`)."""

    def __init__(self, npz_path: str):
        self._data = np.load(npz_path, allow_pickle=False)

    def labels(self, image_id: str, hw: tuple, max_kpts: int = 1024
               ) -> torch.Tensor:
        kpts, valid = _padded(self._data[image_id], max_kpts)
        return distill_labels_from_kpts(kpts, valid, hw[0], hw[1])


def save_teacher_keypoints(npz_path: str,
                           kpts_by_id: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(npz_path, **{k: np.asarray(v, np.float32)
                                     for k, v in kpts_by_id.items()})


def make_xfeat_teacher(weights: str, top_k: int = 1024,
                       detection_threshold: float = 0.05):
    """A trained XFeat as the teacher of the keypoint head: returns a
    function (B,H,W,1) images in [0,1] -> (B,h,w) label maps, computed on
    the images' device without gradients."""
    from ..models.params import load_params
    from ..ops.extraction import detect_and_compute

    cpu_params = load_params(weights)
    cache: Dict[str, object] = {}

    def labels_fn(images: torch.Tensor) -> torch.Tensor:
        dev = str(images.device)
        if dev not in cache:
            cache[dev] = tree_map(lambda t: t.to(images.device), cpu_params)
        with torch.no_grad():
            out = detect_and_compute(cache[dev], images, top_k=top_k,
                                     detection_threshold=detection_threshold)
        h, w = images.shape[1] // 8, images.shape[2] // 8
        return torch.stack([distill_labels_from_kpts(k, v, h, w) for k, v
                            in zip(out["keypoints"], out["valid"])])

    return labels_fn
