"""The rate of the tensor-core instruction the port's matrix kernels use,
`mma.sync.m16n8k8` with TF32 operands and float32 accumulation, on the card.

    python3 -m accelerated_features_tpu_torch.tools.mma_rate

Kernels C, D and D's backward issue this instruction (three of them for
each float32-grade product, `csrc/tf32x3.cuh`). Their bounds are stated
against the card's published dense TF32 peak; this measures what the
instruction sustains: every warp runs a long loop of products into
ACC independent accumulators from registers (no memory traffic), with
W warps a block and one block an SM (pinned by unused shared memory;
four waves), timed with CUDA events after a warm-up. Prints one JSON line
per (W, ACC): TFLOP/s, and the share of 495 TFLOP/s.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops.cuda import _build

PEAK_TF32 = 495e12
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int ACC>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed ^ (threadIdx.x * 7919u + i);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 104729u + i);
  float c[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 120 KB of (unused) dynamic shared memory keeps one block on an SM
#define PIN (120 << 10)

template <int ACC>
static cudaError_t launch(float* out, int blocks, int warps, int iters,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mma_loop<ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, PIN);
  if (err != cudaSuccess) return err;
  mma_loop<ACC><<<blocks, 32 * warps, PIN, s>>>(out, iters, 1u);
  return cudaGetLastError();
}

extern "C" int run(float* out, int blocks, int warps, int acc, int iters,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (acc) {
    case 4: return (int)launch<4>(out, blocks, warps, iters, s);
    case 8: return (int)launch<8>(out, blocks, warps, iters, s);
    case 16: return (int)launch<16>(out, blocks, warps, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.run.restype = ctypes.c_int
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        iters, waves = 4096, 4
        for warps in (4, 8, 16):
            for acc in (4, 8, 16):
                blocks = sms * waves
                out = torch.empty(blocks * 32 * warps, device="cuda")

                def call():
                    rc = lib.run(ctypes.c_void_p(out.data_ptr()), blocks,
                                 warps, acc, iters, stream)
                    if rc:
                        raise RuntimeError(f"mma_rate: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                flops = blocks * warps * iters * acc * 2.0 * 16 * 8 * 8
                rate = flops / ms / 1e9
                print(json.dumps({
                    "device": torch.cuda.get_device_name(0),
                    "warps_a_block": warps, "accumulators_a_warp": acc,
                    "ms": ms, "tflops": rate,
                    "share_of_495": rate * 1e12 / PEAK_TF32}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
