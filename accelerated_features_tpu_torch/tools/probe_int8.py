"""Probe of the card's int8 tensor cores against bfloat16 at a backbone
convolution's shape (counterpart of the JAX package's
`apps/probe_int8_mxu.py`; a probe of the card, not a port of a kernel:
both products are library calls).

    python -m accelerated_features_tpu_torch.tools.probe_int8 \\
        [--batch 64] [--res 640x480] [--stride 16] [--iters 30] \\
        [--device cpu]

The product is the im2col of a 64 -> 64 3x3 convolution of the backbone at
stride `stride` of a B x `res` batch: M = B * H/stride * W/stride, K =
9 * 64 = 576, N = 64. `torch._int_mm` (int8 x int8 -> int32, cuBLASLt's
int8 tensor-core path) against `torch.mm` of the same values in bfloat16
(float32 output where this torch build has `out_dtype`, else bfloat16 with
float32 accumulation). The int8 product must equal the exact integer
product. One JSON line: both times (`utils/profiling.scan_time`), the
speedup, the rates, and the device with the card's power limit. An int8
inference path is worth designing only if the speedup is well above 1 at
this shape (the H100's dense int8 peak is 2x its bfloat16 peak). The
device defaults to the card and the run raises without one.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from ..api import resolve_device
from ..apps.eval_slam import device_label
from ..utils.profiling import scan_time


def run(args, device: torch.device) -> Dict:
    W, H = map(int, args.res.split("x"))
    M, K, N = args.batch * (H // args.stride) * (W // args.stride), 9 * 64, 64
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(
        np.int8)).to(device)
    b8 = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(
        np.int8)).to(device)
    abf, bbf = a8.to(torch.bfloat16), b8.to(torch.bfloat16)

    def dot_bf(x, y):
        return torch.mm(x, y, out_dtype=torch.float32)

    with torch.inference_mode():
        exact = torch.mm(a8[:256].double(), b8.double())
        try:
            got = torch._int_mm(a8[:256].contiguous(), b8)
        except RuntimeError:    # a build whose int8 GEMM wants B K-major
            b8 = b8.t().contiguous().t()
            got = torch._int_mm(a8[:256].contiguous(), b8)
        if not torch.equal(got.double(), exact):
            raise AssertionError("torch._int_mm differs from the exact "
                                 "integer product")
        try:
            dot_bf(abf[:32], bbf)
            out_dtype = "float32"
        except (RuntimeError, TypeError):
            out_dtype = "bfloat16"

            def dot_bf(x, y):   # noqa: F811
                return torch.mm(x, y)
        t_bf = scan_time(dot_bf, abf, bbf, iters=args.iters)
        t_i8 = scan_time(torch._int_mm, a8, b8, iters=args.iters)
    flops = 2 * M * K * N
    out = {"M": M, "K": K, "N": N, "bf16_ms": t_bf * 1e3,
           "bf16_out_dtype": out_dtype, "int8_ms": t_i8 * 1e3,
           "speedup_int8": t_bf / t_i8, "bf16_tflops": flops / t_bf / 1e12,
           "int8_tops": flops / t_i8 / 1e12, "device": device_label(device)}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--res", type=str, default="640x480")
    ap.add_argument("--stride", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return run(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
