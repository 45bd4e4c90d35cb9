"""Kernel B: descriptor sampling with both L2 normalizations
(`csrc/bicubic.cu`).

Counterpart of the TPU kernels `sample_bicubic_fused` and
`sample_bicubic_w2` in `accelerated_features_tpu/ops/pallas/bicubic.py`,
which sample an already normalized map. Kernel B takes the backbone's raw
map and normalizes each tap it reads, so the sparse path runs no separate
per-pixel normalization. `sample_descriptors` launches the kernel on CUDA
tensors; on CPU tensors it runs the plain version,
`l2_normalize(sample_bicubic(l2_normalize(maps), ...))`.
`sample_descriptors.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..sample import l2_normalize, sample_bicubic
from . import _build


def plain_descriptors(maps: torch.Tensor, pos: torch.Tensor,
                      ref_hw: Tuple[int, int]) -> torch.Tensor:
    """The kernel's function in plain torch."""
    return l2_normalize(sample_bicubic(l2_normalize(maps), pos, ref_hw))


def sample_descriptors(maps: torch.Tensor, pos: torch.Tensor,
                       ref_hw: Tuple[int, int]) -> torch.Tensor:
    """Raw (B,h,w,64) f32 map, (B,K,2) f32 xy positions in the (H,W) =
    `ref_hw` frame -> (B,K,64) descriptors: the map L2-normalized per
    pixel, sampled bicubically, L2-normalized per keypoint."""
    if maps.device.type == "cpu":
        return plain_descriptors(maps, pos, ref_hw)
    _build.check_cuda(maps, "maps", torch.float32, 4)
    _build.check_cuda(pos, "pos", torch.float32, 3)
    b, h, w, c = maps.shape
    k = pos.shape[1]
    if c != 64 or pos.shape[0] != b or pos.shape[2] != 2:
        raise ValueError(f"need maps (B,h,w,64) and pos (B,K,2), got "
                         f"{tuple(maps.shape)} and {tuple(pos.shape)}")
    if maps.data_ptr() % 16 or pos.data_ptr() % 8:
        raise ValueError("maps must be 16-byte and pos 8-byte aligned")
    _build.refuse_grad("kernel B (bicubic)", maps, pos)
    H, W = ref_hw
    out = torch.empty((b, k, c), dtype=torch.float32, device=maps.device)
    lib = _lib()
    with torch.cuda.device(maps.device):
        _build.launch(lib, "bicubic_sample_normalize", _build.ptr(maps),
                      _build.ptr(pos), _build.ptr(out), b, h, w, k,
                      ctypes.c_float(np.float32(w / (W - 1))),
                      ctypes.c_float(np.float32(h / (H - 1))),
                      _build.stream(maps))
    sample_descriptors.launches += 1
    return out


sample_descriptors.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("bicubic")
    lib.bicubic_sample_normalize.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.bicubic_sample_normalize.restype = ctypes.c_int
    return lib
