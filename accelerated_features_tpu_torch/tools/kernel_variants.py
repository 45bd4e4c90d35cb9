"""Build variants of the port's kernels in one run on the card, hold each
against its plain version and time it.

    python3 -m accelerated_features_tpu_torch.tools.kernel_variants SPEC

SPEC is JSON: {KERNEL: {name: [nvcc flags]}, "src": {name:
"path/to/other.cu"}, "tile_q": {name: rows}, "tile_k": {name: keys}} with
KERNEL one of "mnn" (C, `csrc/mnn.cu`), "attention" (D), "attention_bwd"
(D's backward, `csrc/attention_bwd.cu`), "stem_fused" (E), "detect_fused"
(A) and "bicubic" (B). A variant is the kernel's source,
or the file "src" names for it (relative to the working directory),
compiled with
`ops/cuda/_build.NVCC_FLAGS` plus its own flags (`-DKNOB=...` for `#ifdef`
knobs put into a source while a design is tried; `-I csrc` is given), all
in parallel, into a temporary directory. "tile_q" / "tile_k" tell the
attention wrapper a variant's tile sizes. Each variant is swapped in behind
the unchanged wrapper, run at the shapes of `chip_smoke.py`'s timing table
and compared with the plain version:
  C: B = 1, K1 = K2 = 4096 seeded unit descriptors, ragged masks; rows
     that differ;
  D: B = 1, Nq = Nk = 4096, D = 96, a tenth of the keys masked; max abs
     error;
  D's backward: the same shape and mask (its own seeded q, k, v, dO; o
     and the log-sum-exp from kernel D), and LighterGlue training's shape
     (B = 8, 512 x 512, D = 96, ragged masks, one item all masked); max
     abs error of dq, dk, dv against `attention_backward_reference`;
  E: B = 1, 608x800, the trained extractor's stem on a seeded texture, in
     float32 (max abs error) and bfloat16 (max abs error against the plain
     bfloat16 version);
  A: B = 1, 800x608, the trained extractor's heatmap of the same texture:
     `topk_keypoints_fused` at K = 4096 (whole stage) and `topk_exact` on
     the XFeat* shape (12740 cells, K = 3276); values that differ;
  B: B = 1, the trained extractor's raw 76x100x64 map of the same texture
     at its K = 4096 keypoints; max abs error.
Each is timed twice, in turns, with `utils/profiling.time_ms` (L2
evicted, device time). For each variant it prints ptxas's register and spill
report. A variant that exports `read_dbg(long long[16])` (sums of
`clock64()` per phase, kept by the kernel in a `__device__` array) gets
those printed for one call of each timed function.
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
from accelerated_features_tpu_torch.ops.cuda import (  # noqa: E402
    _build, attention, bicubic, detect_fused, mnn, stem_fused)
from accelerated_features_tpu_torch.utils.profiling import \
    time_ms  # noqa: E402
from accelerated_features_tpu_torch.ops.matching import \
    batch_mnn_match  # noqa: E402

MODULES = {"mnn": mnn, "attention": attention, "attention_bwd": attention,
           "stem_fused": stem_fused, "detect_fused": detect_fused,
           "bicubic": bicubic}
ENTRIES = {"mnn": ["mnn_match"], "attention": ["attention_forward"],
           "attention_bwd": ["attention_backward"],
           "stem_fused": ["stem_fused"],
           "detect_fused": ["detect_topk", "topk_exact"],
           "bicubic": ["bicubic_sample_normalize"]}
# the module function that returns a kernel's loaded library
LOADERS = {"attention_bwd": "_bwd_lib"}


def build(spec: dict, out_dir: Path) -> dict:
    """{(kernel, variant): loaded library}; prints each ptxas report."""
    procs = {}
    for kern in MODULES:
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
            if "Compiling entry" in line and (
                    key[0] in ("stem_fused", "detect_fused", "bicubic",
                               "attention_bwd")
                    or "panel" in line or "ILi96" in line):
                print(key, line.split("'")[1][-40:], "|",
                      lines[i + 2].strip(), "|", lines[i + 3].strip())
        libs[key] = ctypes.CDLL(str(out))
    return libs


def cases() -> dict:
    """{kernel: [(label, call, error of one call's result)]} at the main
    path's shapes."""
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
    bwd = [_bwd_case(rng, 1, 4096, mk), _bwd_case(
        rng, 8, 512, torch.tensor(_train_mask(rng), device=dev))]

    def mnn_err(out):
        return int(((out[0] != i_p) | (out[1] != m_p)).sum())

    # the trained extractor on a seeded texture: E's input, A's heatmap
    from accelerated_features_tpu_torch import xfeat_forward
    from accelerated_features_tpu_torch.models.backbone import input_norm
    from accelerated_features_tpu_torch.models.params import load_params
    from accelerated_features_tpu_torch.ops.detect import (_padded_top_k,
                                                            heatmap_decode,
                                                            score_map,
                                                            topk_keypoints)
    from accelerated_features_tpu_torch.ops.resize import to_unit_float
    params = load_params(str(ROOT / "artifacts" / "run_md_ckpt13250.npz"))
    params = {k_: _to(v_, dev) for k_, v_ in params.items()}
    img = chip_smoke.texture(0, chip_smoke.H, chip_smoke.W)
    x = to_unit_float(torch.from_numpy(img[None, ..., None].repeat(3, -1))
                      .to(dev))
    with torch.no_grad():
        feats, logits, heat = xfeat_forward(params, x)
    xg = input_norm(x).contiguous()
    x16 = xg.to(torch.bfloat16)
    e32 = stem_fused.stem_reference(params, xg)
    e16 = stem_fused.stem_reference(params, x16)
    kh = heatmap_decode(logits).contiguous()
    rl = heat[..., 0].contiguous()
    top = topk_keypoints(score_map(kh, rl, chip_smoke.THR), chip_smoke.TOP_K)
    cells = torch.tensor(rng.uniform(size=(1, 12740)), dtype=torch.float32,
                         device=dev)
    top_cells = _padded_top_k(cells, 3276)
    maps = feats.contiguous()
    kpts = top[0].float().contiguous()
    hw = (chip_smoke.H, chip_smoke.W)
    descs = bicubic.plain_descriptors(maps, kpts, hw)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def differ(out, want):
        return sum(int((bits(a) != bits(b)).sum()) for a, b in zip(out, want))

    return {
        "mnn": [("K=4096", lambda: mnn.batch_mnn_match_fused(
            d1, d2, va, vb, -1.0), mnn_err)],
        "attention": [("4096x4096x96", lambda: attention.flash_attention(
            q, k, v, mk), lambda o: float((o - ref).abs().max()))],
        "attention_bwd": [
            (label, lambda a=args: attention.attention_backward(*a),
             lambda o, w=want: max(float((x - y).abs().max())
                                   for x, y in zip(o, w)))
            for label, (args, want) in zip(
                ("4096x4096x96", "B=8 512x512x96"), bwd)],
        "stem_fused": [
            ("float32", lambda: stem_fused.stem_fused(params, xg),
             lambda o: float((o - e32).abs().max())),
            ("bfloat16", lambda: stem_fused.stem_fused(params, x16),
             lambda o: float((o.float() - e16.float()).abs().max()))],
        "detect_fused": [
            ("stage K=4096", lambda: detect_fused.topk_keypoints_fused(
                kh, rl, chip_smoke.TOP_K, chip_smoke.THR),
             lambda o: differ(o, top)),
            ("topk_exact 12740/3276", lambda: detect_fused.topk_exact(
                cells, 3276), lambda o: differ(o, top_cells))],
        "bicubic": [("K=4096", lambda: bicubic.sample_descriptors(
            maps, kpts, hw), lambda o: float((o - descs).abs().max()))],
    }


def _train_mask(rng) -> np.ndarray:
    """LighterGlue training's key masks at B = 8, 512 keys: ragged, item 0
    all masked."""
    keep = rng.uniform(size=(8, 512)) > 0.2
    keep[1, 256:] = False
    keep[0] = False
    return keep


def _bwd_case(rng, b: int, n: int, mask: torch.Tensor):
    """(attention_backward's arguments, its plain version's result) for b
    items of n keys, D = 96, seeded q, k, v, dO; o and the log-sum-exp from
    kernel D."""
    dev = mask.device
    q, k, v, do = (torch.tensor(rng.normal(size=(b, n, 96)),
                                dtype=torch.float32, device=dev)
                   for _ in range(4))
    scale = 96 ** -0.5
    o, lse = attention._forward(q, k, v, mask, scale, want_lse=True)
    args = (q, k, v, mask, o, lse, do, scale)
    return args, attention.attention_backward_reference(*args)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    spec = json.loads(sys.argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    by_kernel = cases()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(spec, Path(tmp))
        times = {}
        for turn in range(2):
            for (kern, name), lib in libs.items():
                lib.error_string.argtypes = [ctypes.c_int]
                lib.error_string.restype = ctypes.c_char_p
                module = MODULES[kern]
                loader = LOADERS.get(kern, "_lib")
                real = getattr(module, loader)
                arg_lib = real()  # the argtypes of the real one
                for entry in ENTRIES[kern]:
                    getattr(lib, entry).argtypes = \
                        getattr(arg_lib, entry).argtypes
                    getattr(lib, entry).restype = ctypes.c_int
                setattr(module, loader, lambda lib=lib: lib)
                if kern == "attention":
                    attention._TILE_Q = spec.get("tile_q", {}).get(name, 128)
                    attention._TILE_K = spec.get("tile_k", {}).get(name, 64)
                with torch.no_grad():
                    for label, call, err in by_kernel[kern]:
                        off = err(call())
                        t = time_ms(call)
                        times.setdefault((kern, name, label), []).append(t)
                        if turn == 0:
                            continue
                        print(f"{kern:12s} {name:14s} {label:22s} ms "
                              f"{times[kern, name, label]} error {off}")
                        if hasattr(lib, "read_dbg"):
                            clocks = (ctypes.c_longlong * 16)()
                            lib.read_dbg(clocks)  # clears the sums
                            call()
                            torch.cuda.synchronize()
                            lib.read_dbg(clocks)
                            print(f"   clocks by phase, one call: "
                                  f"{list(clocks)}")
                setattr(module, loader, real)
    return 0


if __name__ == "__main__":
    sys.exit(main())
