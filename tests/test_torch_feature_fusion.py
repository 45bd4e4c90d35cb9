"""Kernel F's wrapper, `ops/cuda/feature_fusion.fuse_pyramid`, on the CPU:
its plain version against the backbone's expression, the shapes it
refuses, and which calls of `xfeat_forward` route to it. The kernel itself
is held to the plain version on the card (`tests/test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from accelerated_features_tpu_torch.models import backbone
from accelerated_features_tpu_torch.models.params import load_params
from accelerated_features_tpu_torch.ops.cuda.feature_fusion import (
    fuse_pyramid, fuse_pyramid_reference)


def pyramid(b, h, w, seed=0, c=64):
    """block3, block4 and block5 outputs of an (h, w) image: ReLU'd seeded
    normals at /8, /16 and /32."""
    rng = np.random.default_rng(seed)

    def level(s):
        return torch.relu(torch.tensor(rng.normal(size=(b, c, h // s, w // s)),
                                       dtype=torch.float32))
    return level(8), level(16), level(32)


def kernel_windows(x3, x4, x5):
    """Kernel F's arithmetic (`csrc/feature_fusion.cu`) in numpy float32:
    each output quad 4q..4q+3 of a row reads x4 columns 2q-1..2q+2 and x5
    columns q-1..q+1, clamped to the row, at the offsets {0,1,1,2} and
    {0,0,1,1}, with upsample_bilinear2d's half-pixel row and column
    weights; then (x3 + up4) + up5."""
    f = np.float32
    x3, x4, x5 = (t.numpy() for t in (x3, x4, x5))
    h, w = x3.shape[2:]
    dst_rows, dst = np.arange(h), np.arange(w)
    q, j = dst // 4, dst % 4

    def index(scale, d):
        s = f(scale) * (d.astype(f) + f(0.5)) - f(0.5)
        return np.maximum(s, f(0))

    def up(x, scale, first, offset):
        rows, cols = x.shape[2:]
        r = index(scale, dst_rows)
        r0 = r.astype(np.int64)
        r1 = r0 + (r0 < rows - 1)
        h1 = (r - r0.astype(f))[:, None]
        h0 = f(1) - h1
        c = index(scale, dst)
        w1 = c - c.astype(np.int64).astype(f)
        w0 = f(1) - w1
        ca = np.clip(first + offset, 0, cols - 1)
        cb = np.clip(first + offset + 1, 0, cols - 1)
        top, bottom = x[:, :, r0], x[:, :, r1]
        return h0 * (w0 * top[..., ca] + w1 * top[..., cb]) \
            + h1 * (w0 * bottom[..., ca] + w1 * bottom[..., cb])

    up4 = up(x4, 0.5, 2 * q - 1, (j + 1) // 2)
    up5 = up(x5, 0.25, q - 1, j // 2)
    return torch.from_numpy((x3 + up4) + up5)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h,w", [(32, 32), (64, 96), (608, 800)])
def test_plain_version_is_the_backbones_expression(b, h, w):
    """`fuse_pyramid` on CPU tensors is the backbone's inline expression to
    the bit, and kernel F's window and weight arithmetic, run in numpy,
    lies within 4 ulp of each of its values: the kernel follows PyTorch's
    CUDA bilinear kernel, whose products round in another order than its
    CPU kernel's (at most 3 ulp apart on these inputs); a wrong column
    offset, clamp or weight is off by far more."""
    x3, x4, x5 = pyramid(b, h, w, seed=b + h)
    hw = (h // 8, w // 8)
    inline = x3 + F.interpolate(x4, size=hw, mode="bilinear",
                                align_corners=False) \
        + F.interpolate(x5, size=hw, mode="bilinear", align_corners=False)
    got = fuse_pyramid(x3, x4, x5)
    assert got.shape == (b, 64) + hw and got.is_contiguous()
    assert torch.equal(got, inline)
    mag = inline.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    diff = (kernel_windows(x3, x4, x5) - inline).abs()
    assert bool((diff <= 4 * ulp).all()), float((diff / ulp).max())


def _refused():
    x3, x4, x5 = pyramid(2, 64, 96)
    up = F.interpolate(x4, scale_factor=2)  # x3's size: ratio 1
    return {
        "x4 at ratio 1": (x3, up, x5),
        "x5 at ratio 2": (x3, x4, x4),
        "x4 at ratio 3": (x3, x4[:, :, :3, :4].contiguous(), x5),
        "x3 width not divisible by 4": (x3[..., :6].contiguous(),
                                        x4[..., :3].contiguous(),
                                        x5[..., :1].contiguous()),
        "non-contiguous x3": (x3.transpose(2, 3).contiguous()
                              .transpose(2, 3), x4, x5),
        "non-contiguous x5": (x3, x4, x5[:, :, :, :].transpose(2, 3)
                              .contiguous().transpose(2, 3)),
        "channels of x4 differ": (x3, x4[:, :32].contiguous(), x5),
        "channels of x5 differ": (x3, x4, x5[:, :63].contiguous()),
        "batch of x5 differs": (x3, x4, x5[:1].contiguous()),
        "dtype of x4 differs": (x3, x4.double(), x5),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_wrapper_refuses(case):
    x3, x4, x5 = _refused()[case]
    with pytest.raises(ValueError):
        fuse_pyramid(x3, x4, x5)


@pytest.mark.parametrize("case,kernel", [
    ("float32 inference", 1), ("train", 0), ("bfloat16", 0),
    ("weights that require grad", 0), ("same weights under no_grad", 1),
    ("sides not divisible by 32", 1)])
def test_backbone_routes_by_what_the_input_shows(monkeypatch, case, kernel):
    """`xfeat_forward` calls `fuse_pyramid` (on the card: kernel F) once in
    float32 inference with nothing recording a gradient through it, and the
    plain expression otherwise; on the CPU both give the plain result.
    Sides not divisible by 32 (48x80: block3 6x10, block4 3x5, block5 2x3)
    reach `fuse_pyramid`, which refuses them."""
    calls = {"fuse_pyramid": 0, "fuse_pyramid_reference": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call
    monkeypatch.setattr(backbone, "fuse_pyramid",
                        counted("fuse_pyramid", fuse_pyramid))
    monkeypatch.setattr(backbone, "fuse_pyramid_reference",
                        counted("fuse_pyramid_reference",
                                fuse_pyramid_reference))
    params = load_params(None, fold_bn=case != "train")
    hw = (48, 80) if case == "sides not divisible by 32" else (32, 64)
    x = torch.tensor(np.random.default_rng(0).uniform(size=(2, *hw, 3)),
                     dtype=torch.float32)
    kw = {}
    if case == "train":
        kw["train"] = True
    elif case == "bfloat16":
        kw["compute_dtype"] = torch.bfloat16
    elif case in ("weights that require grad", "same weights under no_grad"):
        for p in params["block3"]:
            p["w"].requires_grad_(True)
    with torch.set_grad_enabled(case != "same weights under no_grad"):
        if case == "sides not divisible by 32":
            with pytest.raises(ValueError):
                backbone.xfeat_forward(params, x, **kw)
        else:
            out = backbone.xfeat_forward(params, x, **kw)
    assert calls == {"fuse_pyramid": kernel,
                     "fuse_pyramid_reference": 1 - kernel}
    if case == "weights that require grad":
        out[0].sum().backward()
        assert params["block3"][0]["w"].grad is not None
