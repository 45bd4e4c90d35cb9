"""Batched extraction and matching for the eval harnesses (counterpart of
the JAX package's `eval/batched.py`).

The pose benchmarks are per-pair loops by protocol: batch size 1 on the
accelerator. These helpers bucket the eval images by size, run batched
`detect_and_compute` per bucket, and match pairs with the batched masked
MNN, producing the per-pair results.

`compute_dtype` defaults to float32, the dtype of the per-pair path, so
batched and per-pair runs agree; pass `torch.bfloat16` explicitly for
throughput mode and record it in any cache key.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.cuda.mnn import batch_mnn_match_fused
from ..ops.extraction import detect_and_compute
from ..utils.imageio import imread, resize

Feats = Tuple[np.ndarray, np.ndarray, np.ndarray]   # kpts, descs, valid


@torch.inference_mode()
def extract_features_batched(params: Dict[str, Any],
                             records: Sequence[tuple], data_root: str,
                             top_k: int, detection_threshold: float,
                             compute_dtype: Optional[torch.dtype] = None,
                             batch_size: int = 8, progress: bool = True,
                             tag: str = "batched-extract",
                             fused_stem: bool = False
                             ) -> Dict[object, Feats]:
    """records: (key, relative_path, size_hw or None). Images sharing a
    size_hw are grouped into batches; size_hw None means the file's own
    size (bucketed by actual shape, each file decoded once, buckets
    flushed as they fill). `params` is the port's tensor tree; the batches
    run on its device. Returns {key: (kpts, descs, valid)} as numpy. PNGs
    and JPEGs are read and resized without cv2 (`utils/imageio`)."""
    if compute_dtype is None:
        compute_dtype = torch.float32    # per-pair-path parity default
    device = params["skip1"]["w"].device
    out: Dict[object, Feats] = {}
    total = len(records)
    done = 0

    def run_batch(chunk_keys, imgs):
        nonlocal done
        # uint8 crosses to the device; /255 runs inside the extraction
        res = detect_and_compute(
            params, torch.from_numpy(np.stack(imgs)).to(device), top_k,
            detection_threshold, compute_dtype, fused_stem)
        kpts = res["keypoints"].cpu().numpy()
        descs = res["descriptors"].cpu().numpy()
        valid = res["valid"].cpu().numpy()
        for j, key in enumerate(chunk_keys):
            out[key] = (kpts[j], descs[j], valid[j])
        done += len(imgs)
        if progress:
            print(f"\r[{tag}] {done}/{total}", end="", flush=True)

    def decode(path, size_hw=None):
        im = imread(os.path.join(data_root, path))
        return im if size_hw is None else resize(im, size_hw)

    # fixed-size records: lazy per-chunk decode, grouped up front
    sized: Dict[tuple, list] = {}
    native: List[tuple] = []
    for key, path, size_hw in records:
        if size_hw is None:
            native.append((key, path))
        else:
            sized.setdefault(tuple(int(x) for x in size_hw), []) \
                .append((key, path))
    for hw, recs in sized.items():
        for c0 in range(0, len(recs), batch_size):
            chunk = recs[c0:c0 + batch_size]
            run_batch([k for k, _ in chunk],
                      [decode(p, hw) for _, p in chunk])

    # native-size records: decode once, stream into shape buckets and
    # flush each bucket as it fills (at most n_shapes * batch_size decoded
    # images held)
    pend: Dict[tuple, list] = {}
    for key, path in native:
        im = decode(path)
        b = pend.setdefault(im.shape[:2], [])
        b.append((key, im))
        if len(b) == batch_size:
            run_batch([k for k, _ in b], [im for _, im in b])
            b.clear()
    for b in pend.values():
        if b:
            run_batch([k for k, _ in b], [im for _, im in b])
    if progress and total:
        print()
    return out


@torch.inference_mode()
def match_pairs_batched(feats: Dict[object, Feats],
                        id_pairs: Sequence[Tuple[object, object]],
                        batch_size: int = 8, min_cossim: float = -1.0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Batched masked MNN over (key0, key1) pairs on `device` (None: the
    GPU; the fused kernel there, the plain matcher on the CPU); returns
    compacted (mkpts0, mkpts1) per pair, the semantics of `XFeat.match`
    on each pair alone."""
    from ..api import resolve_device
    dev = resolve_device(device)
    matches: List[Tuple[np.ndarray, np.ndarray]] = []
    for c0 in range(0, len(id_pairs), batch_size):
        chunk = list(id_pairs[c0:c0 + batch_size])

        def stack(side, field):
            return torch.from_numpy(np.stack(
                [feats[pair[side]][field] for pair in chunk])).to(dev)

        idx1, mask = batch_mnn_match_fused(stack(0, 1), stack(1, 1),
                                           stack(0, 2), stack(1, 2),
                                           min_cossim)
        idx1, mask = idx1.cpu().numpy(), mask.cpu().numpy()
        for j, (a, b) in enumerate(chunk):
            sel = mask[j]
            matches.append((feats[a][0][sel], feats[b][0][idx1[j][sel]]))
    return matches
