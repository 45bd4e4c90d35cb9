"""MegaDepth training data of the port: the JAX package's
`train/megadepth.py` in numpy, with neither h5py nor cv2.

The on-disk layout is MegaDepth's (and `apps/render_depth_dataset.py`'s):
`<root>/MegaDepth_v1/.../imgs/*`, `.../depths/*.h5` ('/depth'), and
`<root>/train_data/megadepth_indices/scene_info_0.1_0.7/*.npz` with
`image_paths`, `depth_paths`, `intrinsics`, `poses` and `pair_infos`.
Images are read in gray by `utils.imageio.imread_gray` (PNG and JPEG
equal to cv2's reads) and resized by `utils.imageio.resize` (cv2's
fixed-point `INTER_LINEAR`); depth maps by `utils.hdf5.read_dataset`.
So `MegaDepthDataset` items, `collate` and `load_all_views` equal the
JAX package's under `np.array_equal`. s3:// paths need boto3, as in the
JAX package.

`ImageFolderSource` is the synthetic pairs' image pool.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.hdf5 import read_dataset
from ..utils.imageio import imread, imread_gray as _imread_gray, resize


class S3Client:
    """Minimal s3:// object reader on boto3, constructed lazily so that
    local-disk training never imports boto3; without it, raises."""

    def __init__(self, endpoint_url: Optional[str] = None):
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "s3:// paths need boto3 (pip install boto3)") from e
        self._s3 = boto3.client("s3", endpoint_url=endpoint_url)

    def get(self, path: str) -> bytes:
        bucket, _, key = path[len("s3://"):].partition("/")
        return self._s3.get_object(Bucket=bucket, Key=key)["Body"].read()


def read_bytes(path: str, client: Optional[S3Client] = None) -> bytes:
    """The bytes of a local path or an s3:// object."""
    if str(path).startswith("s3://"):
        return (client or S3Client()).get(str(path))
    with open(path, "rb") as f:
        return f.read()


def imread_gray(path: str, client: Optional[S3Client] = None
                ) -> Optional[np.ndarray]:
    """Grayscale image from disk or S3, as `cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)` (`utils.imageio.imread_gray`: PNG and JPEG
    without cv2). None for a missing file."""
    if str(path).startswith("s3://"):
        return _imread_gray(read_bytes(path, client))
    return _imread_gray(path)


def load_depth_h5(path: str, client: Optional[S3Client] = None
                  ) -> Optional[np.ndarray]:
    """HDF5 '/depth' array from disk or S3 as float32, read by
    `utils.hdf5` (no h5py). None for a missing local file."""
    if str(path).startswith("s3://"):
        return read_dataset(read_bytes(path, client)).astype(np.float32)
    if not os.path.exists(path):
        return None
    return read_dataset(path).astype(np.float32)


def fix_path_from_d2net(path: str) -> str:
    """Path fixups carried over from the d2-net index format."""
    if path is None:
        return None
    path = path.replace("Undistorted_SfM/", "")
    if not path.startswith("s3://") and not os.path.exists(path):
        path = path.replace(".jpg", ".JPG")
    return path


def load_scene_index(npz_path: str, min_overlap: float = 0.3,
                     max_overlap: float = 1.0) -> List[Tuple[int, int]]:
    """Read a LoFTR-format scene_info npz and return valid pair indices
    filtered by overlap."""
    info = np.load(npz_path, allow_pickle=True)
    pair_infos = info["pair_infos"]
    pairs = []
    for pi in pair_infos:
        (i0, i1), overlap = pi[0], pi[1]
        if min_overlap < overlap < max_overlap:
            pairs.append((int(i0), int(i1)))
    return pairs


class MegaDepthDataset:
    """One scene; yields pair dicts: images (H, W, 1) float32 in [0, 1]
    resized to `image_size` (W, H), depths zero-padded to depth_pad^2,
    K, the relative poses and the resize scales."""

    def __init__(self, root_dir: str, npz_path: str,
                 image_size: Tuple[int, int] = (800, 608),
                 depth_pad: int = 2000,
                 min_overlap: float = 0.3, max_overlap: float = 1.0,
                 client: Optional[S3Client] = None):
        self.root = root_dir
        self.image_size = image_size  # (W, H)
        self.depth_pad = depth_pad
        self.client = client  # set (or let it lazy-init) for s3:// roots
        info = np.load(npz_path, allow_pickle=True)
        self.image_paths = info["image_paths"]
        self.depth_paths = info["depth_paths"]
        self.intrinsics = info["intrinsics"]
        self.poses = info["poses"]
        self.pairs = load_scene_index(npz_path, min_overlap, max_overlap)

    def __len__(self):
        return len(self.pairs)

    def _join(self, rel: str) -> str:
        if self.root.startswith("s3://"):
            return self.root.rstrip("/") + "/" + str(rel)
        return os.path.join(self.root, str(rel))

    def _load_view(self, idx: int):
        path = self._join(self.image_paths[idx])
        img = imread_gray(fix_path_from_d2net(path), self.client)
        if img is None:
            raise FileNotFoundError(path)
        W, H = self.image_size
        scale = np.array([img.shape[1] / W, img.shape[0] / H], np.float32)
        img = resize(img, (H, W)).astype(np.float32) / 255.0

        depth = np.zeros((self.depth_pad, self.depth_pad), np.float32)
        d = load_depth_h5(self._join(self.depth_paths[idx]), self.client)
        if d is not None:
            depth[:d.shape[0], :d.shape[1]] = d

        K = np.asarray(self.intrinsics[idx], np.float32).reshape(3, 3)
        pose_w2c = np.asarray(self.poses[idx], np.float32).reshape(4, 4)
        return img[..., None], depth, K, pose_w2c, scale

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        i0, i1 = self.pairs[i]
        im0, d0, K0, P0, s0 = self._load_view(i0)
        im1, d1, K1, P1, s1 = self._load_view(i1)
        T_0to1 = P1 @ np.linalg.inv(P0)
        return {
            "image0": im0, "image1": im1,
            "depth0": d0, "depth1": d1,
            "K0": K0, "K1": K1,
            "T_0to1": T_0to1.astype(np.float32),
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "scale0": s0, "scale1": s1,
        }


class MegaDepthLoader:
    """Shuffled multi-scene batch iterator (`random.Random(seed)` order,
    the JAX package's); pairs whose files are missing are skipped."""

    def __init__(self, megadepth_root: str, batch_size: int,
                 image_size=(800, 608), seed: int = 0,
                 npz_glob: str = "train_data/megadepth_indices/"
                                 "scene_info_0.1_0.7/*.npz"):
        src = os.path.join(megadepth_root, "MegaDepth_v1")
        paths = sorted(glob.glob(os.path.join(megadepth_root, npz_glob)))
        if not paths:
            raise FileNotFoundError(
                f"no scene indices under {megadepth_root}/{npz_glob}")
        self.datasets = [MegaDepthDataset(src, p, image_size) for p in paths]
        self.index = [(d_i, p_i) for d_i, d in enumerate(self.datasets)
                      for p_i in range(len(d))]
        self.batch_size = batch_size
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(self.index)
        self.rng.shuffle(order)
        batch = []
        for d_i, p_i in order:
            try:
                batch.append(self.datasets[d_i][p_i])
            except (FileNotFoundError, OSError):
                continue
            if len(batch) == self.batch_size:
                yield collate(batch)
                batch = []

    def infinite(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from iter(self)


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def load_all_views(megadepth_root: str, image_size=(800, 608),
                   npz_glob: str = "train_data/megadepth_indices/"
                                   "scene_info_0.1_0.7/*.npz"):
    """Load EVERY view referenced by any overlap-filtered pair into host
    arrays, for training with the dataset on the device
    (`run.ResidentMegaDepthBatcher`): it ships to the card once and a step
    moves a handful of indices.

    Only for datasets that fit in device memory (a rendered set; real
    MegaDepth goes through the streaming `MegaDepthLoader`). All depth
    maps must share one shape (no 2000^2 padding: `spvs_coarse` takes
    depth at its own resolution).

    Returns dict of stacked arrays:
      images (V, H, W, 1) uint8, depths (V, Hd, Wd) f32, Ks (V, 3, 3),
      scales (V, 2), T_0to1/T_1to0 (Npairs, 4, 4),
      pair_i0/pair_i1 (Npairs,) int32 global view indices.
    """
    src = os.path.join(megadepth_root, "MegaDepth_v1")
    paths = sorted(glob.glob(os.path.join(megadepth_root, npz_glob)))
    if not paths:
        raise FileNotFoundError(
            f"no scene indices under {megadepth_root}/{npz_glob}")
    W, H = image_size
    images, depths, Ks, scales, poses = [], [], [], [], []
    pair_i0, pair_i1 = [], []
    for npz_path in paths:
        ds = MegaDepthDataset(src, npz_path, image_size)
        used = sorted({i for pr in ds.pairs for i in pr})
        local = {}
        for vi in used:
            path = fix_path_from_d2net(ds._join(ds.image_paths[vi]))
            img = imread_gray(path, ds.client)
            if img is None:
                continue
            d = load_depth_h5(ds._join(ds.depth_paths[vi]), ds.client)
            if d is None:
                continue
            local[vi] = len(images)
            scales.append(np.array([img.shape[1] / W, img.shape[0] / H],
                                   np.float32))
            images.append(resize(img, (H, W))[..., None])
            depths.append(np.asarray(d, np.float32))
            Ks.append(np.asarray(ds.intrinsics[vi],
                                 np.float32).reshape(3, 3))
            poses.append(np.asarray(ds.poses[vi],
                                    np.float32).reshape(4, 4))
        for i0, i1 in ds.pairs:
            if i0 in local and i1 in local:
                pair_i0.append(local[i0])
                pair_i1.append(local[i1])
    if not pair_i0:
        raise RuntimeError(f"no loadable pairs under {megadepth_root}")
    shapes = {d.shape for d in depths}
    if len(shapes) != 1:
        raise RuntimeError(
            f"device-resident loading needs uniform depth shapes, got "
            f"{sorted(shapes)[:3]}...; use the streaming MegaDepthLoader")
    poses_np = np.stack(poses)
    i0 = np.asarray(pair_i0, np.int32)
    i1 = np.asarray(pair_i1, np.int32)
    T_0to1 = np.einsum("nij,njk->nik", poses_np[i1],
                       np.linalg.inv(poses_np[i0]))
    return {
        "images": np.stack(images),
        "depths": np.stack(depths),
        "Ks": np.stack(Ks),
        "scales": np.stack(scales),
        "T_0to1": T_0to1.astype(np.float32),
        "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
        "pair_i0": i0,
        "pair_i1": i1,
    }


class ImageFolderSource:
    """Random-image pool for the synthetic augmentation: up to
    `max_num_imgs` images of a directory (`*.jpg`, `*.png`), turned
    landscape and resized to `resolution` (W, H), reshuffled every
    `reload_step` draws. PNGs and JPEGs are read and resized without cv2
    (`utils.imageio`); cv2 is imported only for another format."""

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
