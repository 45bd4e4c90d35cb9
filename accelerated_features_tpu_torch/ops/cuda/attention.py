"""Kernel D: single-head softmax attention with a key mask
(`csrc/attention.cu`).

Counterpart of the TPU kernel `flash_attention` in
`accelerated_features_tpu/ops/pallas/attention.py` (`_attn_kernel`).
`flash_attention` launches the kernel on CUDA tensors; on CPU tensors it
runs the plain version, `attention_reference`. `flash_attention.launches`
counts kernel launches.

The kernel computes both products on the H100's tensor cores at float32
grade (3xTF32: every float32 operand split into a TF32 head and tail, three
`mma.sync` products an output, float32 accumulation), with K and V tiles
staged by `cp.async` through a three-stage ring of shared memory and the
online softmax kept in registers. It is bound by operations: the least
time is 3 * 4*Nq*keys*D / 495 TFLOP/s (dense TF32 peak) for the unmasked
keys. `ops.precision.tf32x3_matmul` emulates its arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG = -1e9
HEAD_DIMS = (32, 64, 96)  # the widths csrc/attention.cu is built for
_TILE_Q = 128     # query rows of a block (BM of the kernel)
_TILE_K = 64      # keys of a tile (BN of the kernel)
_MAX_SPLITS = 16  # bounds the scratch of the key split


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_k: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain torch: softmax(q k^T * scale) v in
    float32, masked keys scored -1e9."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if mask_k is not None:
        s = torch.where(mask_k[:, None, :], s, NEG)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_k: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Nq,D), k and v (B,Nk,D) f32, optional mask_k (B,Nk) bool ->
    (B,Nq,D) f32, softmax(q k^T * scale) v over the keys; `scale` defaults
    to 1/sqrt(D).

    Masked keys score -1e9, not -inf: a row whose keys are all masked gets
    the mean of V over its Nk keys, as `attention_reference` gives. Any
    Nq, Nk >= 1 is taken as it is; keys beyond Nk do not exist, so no
    padding dilutes that mean."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask_k, scale)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_cuda(t, name, torch.float32, 3)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, nq, d = q.shape
    nk = k.shape[1]
    if (d not in HEAD_DIMS or tuple(k.shape) != (b, nk, d)
            or tuple(v.shape) != (b, nk, d) or nq == 0 or nk == 0):
        raise ValueError(f"need non-empty q (B,Nq,D), k and v (B,Nk,D) with "
                         f"D in {HEAD_DIMS}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if mask_k is not None:
        _build.check_cuda(mask_k, "mask_k", torch.bool, 2)
        if tuple(mask_k.shape) != (b, nk):
            raise ValueError(f"mask_k must be ({b}, {nk}), got "
                             f"{tuple(mask_k.shape)}")
    _build.refuse_grad("kernel D (attention)", q, k, v)
    dev = q.device
    # A block takes the whole SM (eight warps, up to 205 KB of shared
    # memory), so the keys are split only while the grid stays within one
    # block an SM: a larger grid would run in two waves. One split needs
    # no scratch and no merge.
    q_tiles, k_tiles = -(-nq // _TILE_Q), -(-nk // _TILE_K)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(sms // (b * q_tiles), k_tiles, _MAX_SPLITS))
    splits = -(-k_tiles // -(-k_tiles // splits))  # no empty split
    null = ctypes.c_void_p(None)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, splits, nq, d), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((b, splits, nq, 2), dtype=torch.float32,
                              device=dev)
    out = torch.empty((b, nq, d), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        _build.launch(lib, "attention_forward", _build.ptr(q), _build.ptr(k),
                      _build.ptr(v),
                      null if mask_k is None else _build.ptr(mask_k),
                      null if part_acc is None else _build.ptr(part_acc),
                      null if part_ml is None else _build.ptr(part_ml),
                      _build.ptr(out), b, nq, nk, d, ctypes.c_float(scale),
                      splits, _build.stream(q))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("attention")
    lib.attention_forward.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p])
    lib.attention_forward.restype = ctypes.c_int
    return lib
