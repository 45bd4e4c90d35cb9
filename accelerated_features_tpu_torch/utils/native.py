"""Host C++ libraries of the port, compiled by g++ at first use and loaded
with ctypes: posekit (`geometry/pose.py`, from `native/posekit.cpp`) and
the JPEG entropy decoder (`utils/imageio.py`, from
`csrc/jpeg_entropy.cpp`).

`CXX` and `CXXFLAGS` are honoured, as `native/Makefile` does. A library
lives in the port's git-ignored `_build/` under a name keyed by the hash of
its source, the compiler, its flags and the host's CPU (`-march=native`
code from another machine may not run here). It is built into a temporary
file and renamed into place, so concurrent first uses never load a
half-written library; a failed build raises the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import List

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_ROOT = PKG_DIR / "_build"
DEFAULT_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17"


def compiler() -> List[str]:
    cxx = os.environ.get("CXX", "g++")
    return [cxx, *os.environ.get("CXXFLAGS", DEFAULT_CXXFLAGS).split(),
            "-shared"]


def host_cpu() -> str:
    """The CPU's model and feature flags, as far as the host tells them."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2])
    except OSError:
        return platform.machine() + platform.processor()


def library_path(source: Path, name: str) -> Path:
    """Where the library `name` of this source, compiler, flags and CPU
    lives."""
    h = hashlib.sha256(" ".join(compiler()).encode())
    h.update(host_cpu().encode())
    h.update(Path(source).read_bytes())
    return BUILD_ROOT / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(path: Path, source: Path, name: str) -> None:
    """Compile `source` into the shared library `path`, or raise the
    compiler's output."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([*compiler(), "-o", tmp, str(source)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} build failed "
                               f"({' '.join(compiler())}):\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
