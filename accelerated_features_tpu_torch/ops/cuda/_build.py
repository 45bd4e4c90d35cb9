"""Build and load the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is a kernel with a plain C interface (`csrc/*.cuh`
are headers they share). At first use,
each one is compiled by its own `nvcc` process (all started together) into
a shared library for Hopper (`sm_90a`), under `_build/<hash>/` beside the
sources; the hash covers every source and the flags, so an edited source
rebuilds and an unchanged one is reused. Libraries are loaded with ctypes.
The compiler's report (`-Xptxas -v`: registers, shared memory and spills
of every kernel) is kept beside each library as `lib<name>.log`.

Each C entry launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises when that is not 0. Kernels A, B, C,
E and F have no backward: their wrappers call `refuse_grad` before they
launch. Kernel D's gradient is a kernel of its own (`attention_bwd.cu`),
wired in by `attention._Attention`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at first use")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(SRC_DIR.glob("*.cu"))}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*sources().values(), *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every source that has no library yet, one `nvcc` per
    source, all in parallel. Returns {name: library path}."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {name: src for name, src in sources().items()
            if not libs[name].exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {todo[name].name}:\n{log}")
        else:
            libs[name].with_suffix(".log").write_text(log)
            os.replace(tmp, libs[name])  # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all()[name]))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(lib: ctypes.CDLL, fn_name: str, *args) -> None:
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record through a kernel that has no
    backward: grad mode is on and an input requires grad. Its output would
    be cut from the graph without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad while grad "
            f"mode is on. Run it under torch.no_grad() or "
            f"torch.inference_mode().")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
               ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
