"""Halo-grouped convolution (counterpart of the JAX package's
`experiments/halo_conv.py`), in plain torch, off every default path.

The XFeat stem runs 3x3 convs with 1-24 channels at full and half
resolution. A direct conv is a matmul with K = 9*C_in (<= 216) and N =
C_out (<= 24). The halo grouping evaluates G consecutive output columns
per matmul row: the im2col patch widens from 3 to G+2 columns (stride 1)
or 2G+1 (stride 2), and the weight matrix becomes a banded (3*win*C_in,
G*C_out) block-Toeplitz expansion of the 3x3 kernel, pushing K and N
toward 128 at a (G+2)/3-fold operation overhead.

On the TPU it was a documented negative result: parity held and the op
won or tied layer by layer in isolation, but routing the stem through it
in the full backbone was slower, because the strided slice-and-stack
im2col broke XLA's fusion of the stem. The JAX package keeps it as a
parity-tested op off the default path, and so does the port; no model
path calls it, and no speed of it on any device is claimed here.

Numerics: the same contraction as the direct conv (zero padding
included) up to float reduction order; the extra band entries multiply
structural zeros.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.precision import full_fp32_matmuls


def _pick_group(w_out: int, c_in: int, c_out: int, stride: int) -> int:
    """Largest group with N = G*C_out <= 128 and K = 3*win*C_in <= 512
    that divides the output width."""
    best = 1
    for g in range(1, 129):
        if w_out % g or g * c_out > 128:
            continue
        win = g + 2 if stride == 1 else 2 * g + 1
        if 3 * win * c_in > 512:
            continue
        best = g
    return best


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                stride: int = 1) -> torch.Tensor:
    """The direct conv in the JAX package's layout: x (B,H,W,C_in), w
    (kh, kw, C_in, C_out) HWIO, pad = kh // 2 -> (B,Ho,Wo,C_out); weight
    and bias cast to x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 None if b is None else b.to(x.dtype), stride=stride,
                 padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def conv2d_halo(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, stride: int = 1,
                group: Optional[int] = None) -> torch.Tensor:
    """NHWC 3x3 conv, torch 'same' padding (pad=1), stride 1 or 2,
    computed as a single grouped-halo matmul. Drop-in for `conv2d_nhwc`
    on 3x3 kernels.

    x: (B, H, W, C_in); w: (3, 3, C_in, C_out) HWIO; H, W divisible by
    stride; the group must divide W // stride (picked when not given).
    float32 products are full float32 (TF32 off for the call)."""
    B, H, W, C = x.shape
    kh, kw, _, Cout = w.shape
    if kh != 3 or kw != 3:
        raise ValueError("the halo conv takes 3x3 kernels")
    Ho, Wo = H // stride, W // stride
    g = group or _pick_group(Wo, C, Cout, stride)
    if g <= 1:
        return conv2d_nhwc(x, w, b, stride)
    win = g + 2 if stride == 1 else 2 * g + 1
    colstride = g * stride

    w = w.to(x.dtype)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))

    parts = []
    for dy in range(3):
        row = xp[:, dy:dy + stride * (Ho - 1) + 1:stride]
        for dx in range(win):
            parts.append(row[:, :, dx:dx + colstride * (Wo // g - 1) + 1:
                             colstride])
    patches = torch.stack(parts, dim=-2)               # (B,Ho,Wo/g,3*win,C)
    patches = patches.reshape(B, Ho, Wo // g, 3 * win * C)

    wmat = torch.zeros((3, win, C, g, Cout), dtype=x.dtype, device=x.device)
    for gx in range(g):
        off = gx if stride == 1 else 2 * gx
        wmat[:, off:off + 3, :, gx, :] = w
    wmat = wmat.reshape(3 * win * C, g * Cout)

    with full_fp32_matmuls():
        out = patches @ wmat
    out = out.reshape(B, Ho, Wo, Cout)
    if b is not None:
        out = out + b.to(out.dtype)
    return out
