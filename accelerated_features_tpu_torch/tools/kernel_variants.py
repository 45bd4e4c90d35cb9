"""Build variants of kernel C (`csrc/mnn.cu`) or D (`csrc/attention.cu`) in
one run on the card, hold each against its plain version and time it.

    python3 -m accelerated_features_tpu_torch.tools.kernel_variants SPEC

SPEC is JSON: {"mnn": {name: [nvcc flags]}, "attention": {name: [flags]},
"src": {name: "path/to/other.cu"}, "tile_q": {name: rows},
"tile_k": {name: keys}}. A variant is the kernel's source, or the file
"src" names for it (relative to the working directory), compiled with
`ops/cuda/_build.NVCC_FLAGS` plus its own flags (`-DKNOB=...` for `#ifdef`
knobs put into a source while a design is tried; `-I csrc` is given), all
in parallel, into a temporary directory. "tile_q" / "tile_k" tell the
attention wrapper a variant's tile sizes. Each variant is swapped in behind
the unchanged wrapper, run at the shapes of `chip_smoke.py`'s timing table
(C: B = 1, K1 = K2 = 4096 seeded unit descriptors with ragged masks; D:
B = 1, Nq = Nk = 4096, D = 96, a tenth of the keys masked), compared with
the plain version (C: rows that differ; D: max abs error) and timed twice,
in turns, with `chip_smoke.time_ms` (L2 evicted, device time). For each it
prints ptxas's register and spill report. A variant that exports
`read_dbg(long long[16])` (sums of `clock64()` per phase, kept by the
kernel in a `__device__` array) gets those printed for one call.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from accelerated_features_tpu_torch.ops.cuda import (_build,  # noqa: E402
                                                     attention, mnn)
from accelerated_features_tpu_torch.ops.matching import \
    batch_mnn_match  # noqa: E402


def build(spec: dict, out_dir: Path) -> dict:
    """{(kernel, variant): loaded library}; prints each ptxas report."""
    procs = {}
    for kern in ("mnn", "attention"):
        for name, flags in spec.get(kern, {}).items():
            src = Path(spec.get("src", {}).get(
                name, _build.SRC_DIR / f"{kern}.cu"))
            out = out_dir / f"{kern}_{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                   str(_build.SRC_DIR), *flags, "-o", str(out), str(src)]
            procs[kern, name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(key, "BUILD FAILED\n", log[-3000:])
            continue
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "warning" in line.lower():
                print(key, line[:300])
            if "Compiling entry" in line and ("panel" in line
                                              or "ILi96" in line):
                print(key, lines[i + 2].strip(), "|", lines[i + 3].strip())
        libs[key] = ctypes.CDLL(str(out))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    spec = json.loads(sys.argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    d1 = rng.normal(size=(1, 4096, 64))
    d2 = d1[:, rng.integers(0, 4096, 4096)] \
        + rng.normal(size=(1, 4096, 64)) * 0.5
    d1, d2 = (torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                           dtype=torch.float32, device=dev) for d in (d1, d2))
    ar = torch.arange(4096)
    g = torch.Generator().manual_seed(0)
    va = (torch.rand(4096, generator=g) > 0.05)[None].to(dev)
    vb = ((ar < 3500) & (torch.rand(4096, generator=g) > 0.05))[None].to(dev)
    i_p, m_p = batch_mnn_match(d1, d2, va, vb, -1.0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 4096, 96)),
                            dtype=torch.float32, device=dev) for _ in range(3))
    mk = torch.tensor(rng.uniform(size=(1, 4096)) > 0.1, device=dev)
    ref = attention.attention_reference(q, k, v, mk)
    plain_lib = {"mnn": mnn._lib, "attention": attention._lib}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(spec, Path(tmp))
        times = {}
        for turn in range(2):
            for (kern, name), lib in libs.items():
                lib.error_string.argtypes = [ctypes.c_int]
                lib.error_string.restype = ctypes.c_char_p
                module = mnn if kern == "mnn" else attention
                arg_lib = plain_lib[kern]()  # the argtypes of the real one
                entry = "mnn_match" if kern == "mnn" else "attention_forward"
                getattr(lib, entry).argtypes = getattr(arg_lib, entry).argtypes
                getattr(lib, entry).restype = ctypes.c_int
                module._lib = lambda lib=lib: lib
                if kern == "mnn":
                    def call():
                        return mnn.batch_mnn_match_fused(d1, d2, va, vb, -1.0)
                    i_k, m_k = call()
                    off = int(((i_k != i_p) | (m_k != m_p)).sum())
                else:
                    attention._TILE_Q = spec.get("tile_q", {}).get(name, 128)
                    attention._TILE_K = spec.get("tile_k", {}).get(name, 64)

                    def call():
                        return attention.flash_attention(q, k, v, mk)
                    off = float((call() - ref).abs().max())
                times.setdefault((kern, name), []).append(
                    chip_smoke.time_ms(call))
                if turn == 1:
                    print(f"{kern:9s} {name:14s} ms {times[kern, name]} "
                          f"rows that differ / max abs err {off}")
                    if hasattr(lib, "read_dbg"):
                        clocks = (ctypes.c_longlong * 16)()
                        lib.read_dbg(clocks)  # clears the sums
                        call()
                        lib.read_dbg(clocks)
                        print(f"   clocks by phase, one call: {list(clocks)}")
                module._lib = plain_lib[kern]
    return 0


if __name__ == "__main__":
    sys.exit(main())
