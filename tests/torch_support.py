"""What the port's CPU tests share: the repository's paths, three helpers,
and one rule for the size of torch's thread pool in a test worker.

The rule. Under pytest-xdist each worker's torch starts an intra-op pool of
one thread a core, so 6 workers on 8 cores run 48 threads, and the port's
CPU paths, thousands of small calls each waiting at the pool's barriers,
stall: one SLAM parity test takes 26 s alone, 490 s as one of 6 copies run
at once, and 30 s as one of 6 with a pool of one thread each. So, when
`PYTEST_XDIST_WORKER_COUNT` is set and `OMP_NUM_THREADS` is not, this
module gives torch's pool the worker's share of the CPUs,
`max(1, os.cpu_count() // workers)`, and sets `OMP_NUM_THREADS` to the same
value, which the subprocesses the tests start (the `apps` CLIs, the
`parallel.dryrun` ranks) inherit. Otherwise it changes nothing. Applying it
when the module is imported is enough: every xdist worker imports every
test module while it collects, so the rule is in force before the worker's
first test."""

import os
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ARTIFACTS = ROOT / "artifacts"
FIXTURES = ROOT / "tests" / "fixtures"

# trained weights: the extractor and the LighterGlue matcher
CKPT = str(ARTIFACTS / "run_md_ckpt13250.npz")
LG_CKPT = str(ARTIFACTS / "lighterglue_ft_ckpt7791.npz")
# the rendered pose holdout set (pairs JSON at its root) and its scenes
HOLDOUT = ARTIFACTS / "rendered_pose_holdout"
HOLDOUT_SCENES = HOLDOUT / "MegaDepth_v1"
# committed fixtures: a MegaDepth-layout tree, a ScanNet-1500 subset and a
# full-size depth map
MEGADEPTH_MINI = FIXTURES / "megadepth_mini"
SCANNET_MINI = FIXTURES / "scannet1500_mini"
MEGADEPTH_DEPTH = FIXTURES / "megadepth_depth_608x800"


def pool_size(env: Mapping[str, str], cpus: int) -> Optional[int]:
    """The intra-op pool size of a test worker under `env` on `cpus` CPUs,
    or None to leave torch's own."""
    workers = env.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or "OMP_NUM_THREADS" in env:
        return None
    return max(1, cpus // int(workers))


POOL = pool_size(os.environ, os.cpu_count() or 1)
if POOL is not None:
    os.environ["OMP_NUM_THREADS"] = str(POOL)
    torch.set_num_threads(POOL)


def t(a, grad=False) -> torch.Tensor:
    """A torch copy of an array (a JAX array too), a leaf with a gradient
    when `grad`."""
    x = torch.tensor(np.asarray(a))
    return x.requires_grad_() if grad else x


def leaves(tree, prefix=""):
    """{path: numpy leaf} of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def close(got, ref, rel):
    """|got - ref| <= rel * max|ref| elementwise: float32 rounding of sums
    whose terms reach max|ref|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= rel, (err, rel)
