"""Kernel E: the fused XFeat stem, block1 plus the avg-pool skip
(`csrc/stem_fused.cu`).

Counterpart of the TPU kernel `stem_fused` in
`accelerated_features_tpu/experiments/stem.py`; the wrapper lives here,
beside the port's other kernels, not under an `experiments/` package.
`stem_fused` launches the kernel on CUDA tensors; on CPU tensors it runs
the plain version, `stem_reference`. `stem_fused.launches` counts kernel
launches.

The port's backbone is NCHW inside, so both functions take the normalized
gray image as (B,1,H,W) and return (B,24,H/4,W/4), what block2's
convolution reads (the JAX functions take and return NHWC). The input's
dtype, float32 or bfloat16, is the compute dtype. In bfloat16 both follow
the TPU kernel's rounding points: input and weights are bf16 values,
products are summed in float32, the float32 bias is added, ReLU, and each
activation is rounded to bf16 between layers; the pooled row sums are
rounded to bf16, the skip weight carries the pooling's 1/16 (exact), and
the final sum is float32, rounded once.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..precision import full_fp32_convs
from . import _build

STRIDES = (1, 2, 1, 2)
N_PARAMS = 2720  # csrc/stem_fused.cu: 2628 conv weights, 68 biases, skip
_DTYPES = (torch.float32, torch.bfloat16)

Layer = Tuple[torch.Tensor, torch.Tensor]


def stem_weights(params: Dict[str, Any], dtype: torch.dtype
                 ) -> Tuple[List[Layer], Layer]:
    """block1's four (weight OIHW, bias) and the skip's (weight / 16,
    bias), as float32 tensors whose weight values are rounded to `dtype`:
    the one place where the stem's weights are cast. Biases stay float32.
    Raises when BatchNorm is not folded into the biases."""
    block1 = params["block1"]
    if any("b" not in p for p in block1):
        raise ValueError("the fused stem needs BatchNorm folded into the "
                         "conv biases (models.params.fold_batchnorm)")

    def rounded(w):
        return w.float().to(dtype).float()

    layers = [(rounded(p["w"]), p["b"].float()) for p in block1]
    skip = params["skip1"]
    return layers, (rounded(skip["w"] / 16.0), skip["b"].float())


def _check_input(xg: torch.Tensor) -> None:
    if xg.dim() != 4 or xg.shape[1] != 1 or xg.dtype not in _DTYPES:
        raise ValueError(f"need a (B,1,H,W) float32 or bfloat16 image, got "
                         f"{xg.dtype} {tuple(xg.shape)}")
    if xg.shape[2] % 32 or xg.shape[3] % 32 or 0 in xg.shape:
        raise ValueError(f"H, W must be divisible by 32, got "
                         f"{tuple(xg.shape[2:])}")


def stem_reference(params: Dict[str, Any], xg: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the `F.conv2d` chain of
    block1 plus the 4x4 pooling and the 1x1 skip conv, on float32 tensors
    that hold `xg.dtype` values, with the rounding points named above. In
    float32 it is the backbone's unfused stem."""
    _check_input(xg)
    dt = xg.dtype
    layers, (ws, bs) = stem_weights(params, dt)
    x = xg.float()
    with full_fp32_convs():
        y = x
        for (w, b), s in zip(layers, STRIDES):
            y = F.relu(F.conv2d(y, w, b, stride=s, padding=1)).to(dt).float()
        rows = F.avg_pool2d(x, (4, 1), divisor_override=1).to(dt).float()
        pool = F.avg_pool2d(rows, (1, 4), divisor_override=1)
        return (y + F.conv2d(pool, ws, bs)).to(dt)


# packed kernel parameters per weight tree: keyed weakly on block1's first
# weight tensor, checked against every tensor's identity and version
_packed = WeakIdKeyDictionary()


def pack_params(params: Dict[str, Any], dtype: torch.dtype) -> torch.Tensor:
    """The (2720,) float32 host vector of `csrc/stem_fused.cu`'s
    parameters, which the kernel takes by value at launch: conv weights as
    [ci][dy][dx][co], then the four biases, the skip weight / 16 and the
    skip bias. Cached until a weight tensor is replaced or written."""
    tensors = [p[k] for p in params["block1"] for k in ("w", "b") if k in p]
    tensors += [params["skip1"]["w"], params["skip1"]["b"]]
    stamp = tuple((id(t), t._version) for t in tensors)
    slot = _packed.setdefault(tensors[0], {})
    hit = slot.get(dtype)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    layers, (ws, bs) = stem_weights(params, dtype)
    flat = [w.permute(1, 2, 3, 0).reshape(-1) for w, _ in layers]
    flat += [b for _, b in layers] + [ws.reshape(-1), bs]
    packed = torch.cat(flat).cpu().contiguous()
    if packed.numel() != N_PARAMS:
        raise ValueError(f"unexpected stem parameter count {packed.numel()}")
    slot[dtype] = (stamp, packed)
    return packed


def stem_fused(params: Dict[str, Any], xg: torch.Tensor) -> torch.Tensor:
    """Normalized gray image (B,1,H,W), float32 or bfloat16, H and W
    divisible by 32, and the folded parameter tree (`block1`, `skip1`) ->
    block2's input (B,24,H/4,W/4) in the same dtype."""
    if xg.device.type == "cpu":
        return stem_reference(params, xg)
    _check_input(xg)
    _build.check_cuda(xg, "xg", xg.dtype, 4)
    b, _, h, w = xg.shape
    wdev = params["block1"][0]["w"].device
    if wdev != xg.device:
        raise ValueError(f"weights on {wdev}, image on {xg.device}")
    layers = [*params["block1"], params["skip1"]]
    _build.refuse_grad("kernel E (stem_fused)", xg,
                       *(p[k] for p in layers for k in ("w", "b") if k in p))
    packed = pack_params(params, xg.dtype)
    out = torch.empty((b, 24, h // 4, w // 4), dtype=xg.dtype,
                      device=xg.device)
    lib = _lib()
    with torch.cuda.device(xg.device):
        _build.launch(lib, "stem_fused", _build.ptr(xg), _build.ptr(packed),
                      _build.ptr(out), b, h, w,
                      int(xg.dtype == torch.bfloat16), _build.stream(xg))
    stem_fused.launches += 1
    return out


stem_fused.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("stem_fused")
    lib.stem_fused.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])
    lib.stem_fused.restype = ctypes.c_int
    return lib
