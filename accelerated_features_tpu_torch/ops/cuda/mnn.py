"""Kernel C: fused mutual-nearest-neighbour matching (`csrc/mnn.cu`).

Counterpart of the TPU kernel `_mnn_kernel` in
`accelerated_features_tpu/ops/pallas/mnn.py`. `batch_mnn_match_fused`
launches the kernel on CUDA tensors; on CPU tensors it runs the plain
version, `ops.matching.batch_mnn_match`; either way, under a profiler, it
is the range `xfeat.mnn`. `batch_mnn_match_fused.launches` counts kernel
launches.

The kernel computes the similarities on the H100's tensor cores at float32
grade (3xTF32: every float32 operand split into a TF32 head and tail, three
`mma.sync` products an output, float32 accumulation). A block keeps a panel
of 128 rows of `d1` in shared memory and walks column tiles of `d2` staged
by `cp.async` through a three-stage ring; the row argmax stays in registers
over the whole walk. It is bound by operations: the least time is
3 * 2*K1*K2*64 / 495 TFLOP/s (dense TF32 peak).
`ops.precision.tf32x3_matmul` emulates its arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...utils.profiling import span
from ..matching import batch_mnn_match
from . import _build


def batch_mnn_match_fused(d1: torch.Tensor, d2: torch.Tensor,
                          valid1: Optional[torch.Tensor] = None,
                          valid2: Optional[torch.Tensor] = None,
                          min_cossim: float = -1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,K1,64), (B,K2,64) f32, optional (B,K1) / (B,K2) bool masks ->
    idx1 (B,K1) int64, mask (B,K1) bool; same semantics as
    `batch_mnn_match` (`min_cossim` <= 0 disables the gate)."""
    with span("xfeat.mnn"):
        if d1.device.type == "cpu":
            return batch_mnn_match(d1, d2, valid1, valid2, min_cossim)
        for t, name in ((d1, "d1"), (d2, "d2")):
            _build.check_cuda(t, name, torch.float32, 3)
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        b, k1, c = d1.shape
        k2 = d2.shape[1]
        if c != 64 or d2.shape[0] != b or d2.shape[2] != c or k1 == 0 \
                or k2 == 0:
            raise ValueError(f"need non-empty (B,K1,64) and (B,K2,64), got "
                             f"{tuple(d1.shape)} and {tuple(d2.shape)}")
        for v, name, k in ((valid1, "valid1", k1), (valid2, "valid2", k2)):
            if v is not None:
                _build.check_cuda(v, name, torch.bool, 2)
                if tuple(v.shape) != (b, k):
                    raise ValueError(f"{name} must be ({b}, {k}), got "
                                     f"{tuple(v.shape)}")
        _build.refuse_grad("kernel C (mnn)", d1, d2)
        dev = d1.device
        keys = torch.empty(b * (k1 + k2), dtype=torch.int64, device=dev)
        idx1 = torch.empty((b, k1), dtype=torch.int64, device=dev)
        mask = torch.empty((b, k1), dtype=torch.bool, device=dev)
        null = ctypes.c_void_p(None)
        lib = _lib()
        with torch.cuda.device(dev):
            _build.launch(lib, "mnn_match", _build.ptr(d1), _build.ptr(d2),
                          null if valid1 is None else _build.ptr(valid1),
                          null if valid2 is None else _build.ptr(valid2),
                          _build.ptr(keys), _build.ptr(idx1), _build.ptr(mask),
                          b, k1, k2, ctypes.c_float(min_cossim),
                          _build.stream(d1))
        batch_mnn_match_fused.launches += 1
        return idx1, mask


batch_mnn_match_fused.launches = 0


def mnn_match_fused(d1: torch.Tensor, d2: torch.Tensor,
                    valid1: Optional[torch.Tensor] = None,
                    valid2: Optional[torch.Tensor] = None,
                    min_cossim: float = -1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pair: (K1,64), (K2,64), optional (K,) masks -> idx1 (K1,),
    mask (K1,)."""
    idx, mask = batch_mnn_match_fused(
        d1[None], d2[None], None if valid1 is None else valid1[None],
        None if valid2 is None else valid2[None], min_cossim)
    return idx[0], mask[0]


def near_ties(d1: torch.Tensor, d2: torch.Tensor,
              valid1: Optional[torch.Tensor] = None,
              valid2: Optional[torch.Tensor] = None,
              min_cossim: float = -1.0, eps: float = 1e-6
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where two correct float32 MNNs may differ, judged in float64.

    Two float32 implementations that sum the 64 products in different
    orders (the kernel's tensor-core tiles, a GEMM library) round
    similarities differently by ~1e-7, so they may pick different columns
    where the top two lie within `eps`. Returns (B,K1) bool `tie`: rows whose top
    two valid columns, or whose best column's top two valid rows, lie
    within `eps`, or whose best similarity lies within `eps` of an active
    `min_cossim`; and (B,K1) float64 `sim_max`, each row's best similarity
    over valid columns (-1e9 where it has none). Differences that come
    from the -1e9 fill are exact and never count as ties."""
    sim = torch.matmul(d1.double(), d2.double().transpose(1, 2))
    fill = torch.tensor(-1e9, dtype=sim.dtype, device=sim.device)
    if valid2 is not None:
        sim = torch.where(valid2[:, None, :], sim, fill)
    simc = sim if valid1 is None else torch.where(valid1[:, :, None], sim,
                                                  fill)

    def close(top: torch.Tensor) -> torch.Tensor:
        if top.shape[-1] < 2:
            return torch.zeros(top.shape[:-1], dtype=torch.bool,
                               device=top.device)
        return (top[..., 0] - top[..., 1] < eps) & (top[..., 1] > -1e8)

    row_top = torch.topk(sim, min(2, sim.shape[2]), dim=2).values
    col_tie = close(torch.topk(simc, min(2, simc.shape[1]), dim=1)
                    .values.transpose(1, 2))
    best = torch.argmax(sim, dim=2)
    tie = close(row_top) | torch.gather(col_tie, 1, best)
    if min_cossim > 0:
        tie |= (row_top[..., 0] - min_cossim).abs() < eps
    return tie, row_top[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _build.library("mnn")
    lib.mnn_match.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                              + [ctypes.c_float, ctypes.c_void_p])
    lib.mnn_match.restype = ctypes.c_int
    return lib
