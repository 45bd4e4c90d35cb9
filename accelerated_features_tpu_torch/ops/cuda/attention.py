"""Kernel D: single-head softmax attention with a key mask
(`csrc/attention.cu`), and its gradient (`csrc/attention_bwd.cu`).

Counterpart of the TPU kernel `flash_attention` in
`accelerated_features_tpu/ops/pallas/attention.py` (`_attn_kernel`).
`flash_attention` launches the kernel on CUDA tensors; on CPU tensors it
runs the plain version, `attention_reference`. `flash_attention.launches`
counts kernel launches. Under autograd (grad mode on, an input requiring
grad) the call goes through `_Attention`: the forward also writes the row
log-sum-exp, and the backward kernel (`attention_backward`, plain version
`attention_backward_reference`) gives dq, dk and dv;
`attention_backward.launches` counts its calls. The backward multiplies on
the tensor cores with `mma.sync`, in one launch whose grid holds both of
its roles (blocks that own keys: dK, dV; blocks that own query rows: dQ)
after a small launch for rowsum(dO * O).

The forward computes both products on the H100's tensor cores at float32
grade (3xTF32: every float32 operand split into a TF32 head and tail, three
products an output, float32 accumulation) and keeps the online softmax in
registers. It is bound by operations: the least time is
3 * 4*Nq*keys*D / 495 TFLOP/s (dense TF32 peak) for the unmasked keys.
Every width runs one warpgroup kernel: a producer warpgroup brings each
key tile of K and V in by two bulk copies (64 keys; 32 at D = 96, whose
planes would not fit twice in shared memory at 64) and splits it once into
TF32 planes (K as stored, V transposed) in a two-stage ring guarded by
mbarriers; two consumer warpgroups of 64 query rows hold Q's planes and P
in registers and run the products as `wgmma`, the only instruction that
reaches the tensor cores' full rate, taking turns so that one's softmax
runs beside the other's products. A block takes 128 query rows and the
whole SM, so `key_splits` splits the keys (merged by a second launch) only
while the grid stays under one wave.
`ops.precision.tf32x3_matmul` emulates the arithmetic on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG = -1e9
HEAD_DIMS = (32, 64, 96)  # the widths csrc/attention.cu is built for
_TILE_Q = 128     # query rows of a block
_TILE_K = 64      # keys of the tiles the key split counts (BN)
_MAX_SPLITS = 16  # bounds the scratch of the key split


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_k: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain torch: softmax(q k^T * scale) v in
    float32, masked keys scored -1e9."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, mask_k, scale)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def _masked_scores(q, k, mask_k, scale):
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    return s if mask_k is None else torch.where(mask_k[:, None, :], s, NEG)


def attention_reference_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            mask_k: Optional[torch.Tensor], scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attention_reference` and the row log-sum-exp (natural log, (B,Nq))
    of the masked, scaled scores, which the backward reads."""
    s = _masked_scores(q, k, mask_k, scale)
    return (torch.matmul(torch.softmax(s, dim=-1), v),
            torch.logsumexp(s, dim=-1))


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask_k: Optional[torch.Tensor],
                                 o: torch.Tensor, lse: torch.Tensor,
                                 dout: torch.Tensor, scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The backward kernel's function in plain torch, by its formulas:
    P = exp(scale q k^T - lse) (uniform 1/Nk in an item whose keys are all
    masked), dV = P^T dO, dS = P (dO V^T - rowsum(dO * O)) cut at masked
    keys, dQ = scale dS K, dK = scale dS^T Q. Returns (dq, dk, dv)."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if mask_k is not None:
        p = torch.where(mask_k[:, None, :], p, 0.0)
        empty = ~mask_k.any(dim=-1)
        p = torch.where(empty[:, None, None], 1.0 / k.shape[1], p)
    dv = torch.matmul(p.transpose(1, 2), dout)
    delta = (dout * o).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dout, v.transpose(1, 2)) - delta)
    if mask_k is not None:
        ds = torch.where(mask_k[:, None, :], ds, 0.0)
    return (torch.matmul(ds, k) * scale,
            torch.matmul(ds.transpose(1, 2), q) * scale, dv)


def _check(q, k, v, mask_k):
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


def key_splits(b: int, nq: int, nk: int, sms: int) -> int:
    """How many ways kernel D's launch splits the keys, for b items of nq
    queries and nk keys on a card of `sms` SMs. A block takes the whole SM
    (128 query rows, up to ~205 KB of shared memory), so the keys are split
    only while the grid stays within one block an SM: a larger grid would
    run in two waves. One split needs no scratch and no merge. The count
    is such that no split is empty in 64-key tiles."""
    q_tiles, k_tiles = -(-nq // _TILE_Q), -(-nk // _TILE_K)
    splits = max(1, min(sms // (b * q_tiles), k_tiles, _MAX_SPLITS))
    return -(-k_tiles // -(-k_tiles // splits))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask_k: Optional[torch.Tensor], scale: float, want_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch kernel D: (out, the row log-sum-exp or None)."""
    _check(q, k, v, mask_k)
    b, nq, d = q.shape
    nk = k.shape[1]
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = key_splits(b, nq, nk, sms)
    null = ctypes.c_void_p(None)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b, splits, nq, d), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((b, splits, nq, 2), dtype=torch.float32,
                              device=dev)
    out = torch.empty((b, nq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, nq), dtype=torch.float32, device=dev) \
        if want_lse else None
    lib = _lib()
    with torch.cuda.device(dev):
        _build.launch(lib, "attention_forward", _build.ptr(q), _build.ptr(k),
                      _build.ptr(v),
                      null if mask_k is None else _build.ptr(mask_k),
                      null if part_acc is None else _build.ptr(part_acc),
                      null if part_ml is None else _build.ptr(part_ml),
                      _build.ptr(out),
                      null if lse is None else _build.ptr(lse),
                      b, nq, nk, d, ctypes.c_float(scale), splits,
                      _build.stream(q))
    flash_attention.launches += 1
    return out, lse


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask_k: Optional[torch.Tensor], o: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of kernel D's function given dO, the output o and the
    forward's row log-sum-exp (natural log, (B,Nq)): the backward kernel
    (`csrc/attention_bwd.cu`) on CUDA tensors, `attention_backward_reference`
    on CPU tensors. `attention_backward.launches` counts kernel calls.

    The kernel multiplies as the forward does, 3xTF32 on the tensor cores,
    and reads q, k, v, o and dout 16 bytes at a time: each must be a
    contiguous float32 tensor on a 16-byte boundary (a ValueError names the
    one that is not). It is bound by operations, 3 x 5 products of
    2*Nq*keys*D at the TF32 peak; two runs give bit-equal gradients."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, mask_k, o, lse, dout,
                                            scale)
    _check(q, k, v, mask_k)
    b, nq, d = q.shape
    nk = k.shape[1]
    for t, name, shape in ((o, "o", (b, nq, d)), (dout, "dout", (b, nq, d)),
                           (lse, "lse", (b, nq))):
        _build.check_cuda(t, name, torch.float32, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if name != "lse" and t.data_ptr() % 16:  # read 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        _build.launch(lib, "attention_backward", _build.ptr(q), _build.ptr(k),
                      _build.ptr(v),
                      ctypes.c_void_p(None) if mask_k is None
                      else _build.ptr(mask_k),
                      _build.ptr(o), _build.ptr(lse), _build.ptr(dout),
                      _build.ptr(delta), _build.ptr(dq), _build.ptr(dk),
                      _build.ptr(dv), b, nq, nk, d, ctypes.c_float(scale),
                      _build.stream(q))
    attention_backward.launches += 1
    return dq, dk, dv


attention_backward.launches = 0


class _Attention(torch.autograd.Function):
    """Kernel D with its gradient: the forward kernel saving the row
    log-sum-exp, the backward kernel for (dq, dk, dv); on CPU tensors
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mask_k, scale):
        if q.device.type == "cpu":
            out, lse = attention_reference_lse(q, k, v, mask_k, scale)
        else:
            out, lse = _forward(q, k, v, mask_k, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_k, ctx.scale = mask_k, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, ctx.mask_k, out, lse,
                                        dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_k: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Nq,D), k and v (B,Nk,D) f32, optional mask_k (B,Nk) bool ->
    (B,Nq,D) f32, softmax(q k^T * scale) v over the keys; `scale` defaults
    to 1/sqrt(D).

    Masked keys score -1e9, not -inf: a row whose keys are all masked gets
    the mean of V over its Nk keys, as `attention_reference` gives. Any
    Nq, Nk >= 1 is taken as it is; keys beyond Nk do not exist, so no
    padding dilutes that mean.

    When grad mode is on and q, k or v requires grad, the call is recorded
    for autograd: the forward also saves the row log-sum-exp and the
    gradient comes from `attention_backward` (the backward kernel on CUDA
    tensors, its plain version on CPU tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, mask_k, scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask_k, scale)
    return _forward(q, k, v, mask_k, scale, want_lse=False)[0]


flash_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("attention")
    lib.attention_forward.argtypes = ([ctypes.c_void_p] * 8
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p])
    lib.attention_forward.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("attention_bwd")
    lib.attention_backward.argtypes = ([ctypes.c_void_p] * 11
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_float, ctypes.c_void_p])
    lib.attention_backward.restype = ctypes.c_int
    return lib
