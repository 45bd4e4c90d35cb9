"""Run one cell of the benchmark once.

    python3 xfeat_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

(or `python3 -m xfeat_bench.run ...`) from the root of a checkout, on a
machine with an NVIDIA card. The last line of standard output is the
result as one JSON object; the last lines of standard error are the
numbers the correctness check compared, each beside its limit.

Exits with 2 and prints no result without enough CUDA cards, and with 3
when JAX, Flax or the JAX package was loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "accelerated_features_tpu"}


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (`accelerated_features_tpu_torch` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout (the
    port builds its kernels into `accelerated_features_tpu_torch/_build`)."""
    cache = BENCH / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    if sys.path and Path(sys.path[0]).resolve() == BENCH:
        sys.path[0] = str(ROOT)      # run as a script: import by package
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch
    from xfeat_bench import spec as spec_mod
    spec = spec_mod.load(ROOT)
    chips = spec_mod.cell(spec, args.workload)["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA card(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from xfeat_bench.harness import run_cell
    print(f"card: {_power_limit()}", file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, ROOT)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark must not load: {bad}",
              file=sys.stderr)
        return 3
    print(f"requests: {result['attempted']}, failed: {result['failed']}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
