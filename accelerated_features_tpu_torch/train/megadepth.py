"""Training image sources of the port: the synthetic source of the JAX
package's `train/megadepth.py` (`ImageFolderSource`).

The MegaDepth depth loader of that module reads HDF5 depth maps and
resizes with cv2, neither of which the port can count on; it waits for a
depth format the port can read. The depth-supervised share of the port's
trainer is rendered instead (`train/render.render_scene_views`).
"""

from __future__ import annotations

import glob
import os
import random
from typing import Tuple

import numpy as np

from ..utils.imageio import imread, resize


class ImageFolderSource:
    """Random-image pool for the synthetic augmentation: up to
    `max_num_imgs` images of a directory (`*.jpg`, `*.png`), turned
    landscape and resized to `resolution` (W, H), reshuffled every
    `reload_step` draws. PNGs are read without cv2 (`utils.imageio`);
    cv2 is imported only for another format or a resize."""

    def __init__(self, img_dir: str, resolution: Tuple[int, int] = (800, 608),
                 max_num_imgs: int = 3000, reload_step: int = 4000,
                 seed: int = 0):
        self.dir = img_dir
        self.resolution = resolution
        self.max_num = max_num_imgs
        self.reload_step = reload_step
        self.rng = random.Random(seed)
        self.all_paths = sorted(
            glob.glob(os.path.join(img_dir, "*.jpg")) +
            glob.glob(os.path.join(img_dir, "*.png")))
        if len(self.all_paths) < 10:
            raise RuntimeError(f"not enough images in {img_dir}")
        self._count = 0
        self._load()

    def _load(self):
        self.rng.shuffle(self.all_paths)
        self.pool = []
        W, H = self.resolution
        for p in self.all_paths[:self.max_num]:
            im = imread(p)
            if im.shape[0] > im.shape[1]:
                im = np.rot90(im)  # landscape
            self.pool.append(np.ascontiguousarray(resize(im, (H, W))))

    def sample_indices(self, n: int) -> Tuple[np.ndarray, bool]:
        """n pool indices and whether the pool changed (a reload that
        brings in other files than those in the pool)."""
        self._count += 1
        changed = False
        if self._count % self.reload_step == 0:
            if len(self.all_paths) > len(self.pool):
                self._load()
                changed = True
        idx = np.asarray([self.rng.randrange(len(self.pool))
                          for _ in range(n)], np.int64)
        return idx, changed

    def pool_u8(self) -> np.ndarray:
        """(N, H, W, 3) uint8 stack of the pool, to keep on the device."""
        return np.stack(self.pool)

    def sample_batch(self, n: int) -> np.ndarray:
        idx, _ = self.sample_indices(n)
        return np.stack([self.pool[i] for i in idx]).astype(np.float32) / 255.0
