"""Kernel F: the backbone's feature-pyramid fusion,
x3 + up(x4) + up(x5) in one pass (`csrc/feature_fusion.cu`).

Replaces no TPU kernel: the JAX package leaves this sum to XLA. On the
card PyTorch's plain expression takes four launches (two bilinear
upsamples, two adds) at 2.5% of the byte bound; kernel F reads each input
once and writes the sum once, at 71% of it (B = 64, 608x800, H100).
`fuse_pyramid` launches the kernel on CUDA tensors; on CPU tensors it runs
the plain version, `fuse_pyramid_reference`. `fuse_pyramid.launches`
counts kernel launches.

The inputs are the NCHW outputs of block3 (B,C,h,w), block4 (B,C,h/2,w/2)
and block5 (B,C,h/4,w/4), as an image whose sides are divisible by 32
gives them; `fuse_pyramid` raises on any other sizes, on the CPU too.
`up` is half-pixel bilinear (`align_corners=False`) to (h,w), and the sums
are taken in the plain order, (x3 + up(x4)) + up(x5).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def fuse_pyramid_reference(x3: torch.Tensor, x4: torch.Tensor,
                           x5: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the backbone's expression,
    for any shapes and dtypes `F.interpolate` takes."""
    hw = (x3.shape[2], x3.shape[3])
    return x3 + _up(x4, hw) + _up(x5, hw)


def _check(x3: torch.Tensor, x4: torch.Tensor, x5: torch.Tensor) -> None:
    """Raise unless x3, x4, x5 are contiguous 4-D tensors of one dtype and
    device, of the same batch and channels, x4 exactly 1/2 and x5 exactly
    1/4 of x3's (H,W), H and W divisible by 4. Other sides of the image
    give block4 and block5 the rounded-up sizes of the strided convs."""
    for name, t in (("x3", x3), ("x4", x4), ("x5", x5)):
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B,C,H,W) tensor, "
                             f"got {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()}")
        if t.dtype != x3.dtype or t.device != x3.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x3 is "
                             f"{x3.dtype} on {x3.device}")
    if x4.shape[:2] != x3.shape[:2] or x5.shape[:2] != x3.shape[:2]:
        raise ValueError(f"batch and channels differ: x3 {tuple(x3.shape)}, "
                         f"x4 {tuple(x4.shape)}, x5 {tuple(x5.shape)}")
    h, w = x3.shape[2:]
    if 0 in x3.shape or h % 4 or w % 4 \
            or tuple(x4.shape[2:]) != (h // 2, w // 2) \
            or tuple(x5.shape[2:]) != (h // 4, w // 4):
        raise ValueError(f"need x4 and x5 at exactly 1/2 and 1/4 of x3's "
                         f"(H,W), H and W divisible by 4: x3 "
                         f"{tuple(x3.shape)}, x4 {tuple(x4.shape)}, x5 "
                         f"{tuple(x5.shape)}")


def fuse_pyramid(x3: torch.Tensor, x4: torch.Tensor,
                 x5: torch.Tensor) -> torch.Tensor:
    """block3 (B,C,h,w), block4 (B,C,h/2,w/2), block5 (B,C,h/4,w/4), NCHW
    and contiguous -> x3 + up(x4) + up(x5), (B,C,h,w) contiguous. CUDA
    tensors must be float32 and take the kernel; CPU tensors take the
    plain version."""
    _check(x3, x4, x5)
    if x3.device.type == "cpu":
        return fuse_pyramid_reference(x3, x4, x5)
    for name, t in (("x3", x3), ("x4", x4), ("x5", x5)):
        _build.check_cuda(t, name, torch.float32, 4)
    if x3.data_ptr() % 16:
        raise ValueError("x3 must be 16-byte aligned")
    if x3.numel() >= 2 ** 31:
        raise ValueError(f"x3 has {x3.numel()} elements; the kernel takes "
                         f"fewer than 2^31")
    _build.refuse_grad("kernel F (feature_fusion)", x3, x4, x5)
    b, c, h, w = x3.shape
    out = torch.empty_like(x3)
    lib = _lib()
    with torch.cuda.device(x3.device):
        _build.launch(lib, "fuse_pyramid", _build.ptr(x3), _build.ptr(x4),
                      _build.ptr(x5), _build.ptr(out), b * c, h, w,
                      _build.stream(x3))
    fuse_pyramid.launches += 1
    return out


fuse_pyramid.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("feature_fusion")
    lib.fuse_pyramid.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
    lib.fuse_pyramid.restype = ctypes.c_int
    return lib
