"""The benchmark's command on the card, briefly, for every cell: it
prints one JSON result with `correct` true. Needs an NVIDIA card; run on
the card's machine from the repository root with

    python -m pytest --noconftest -p no:cacheprovider \
        xfeat_bench/tests/test_xfeat_bench_card.py

(`--noconftest` keeps the JAX test suite's `tests/conftest.py` out)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["sparse.extract-b64", "lg.pairs-k4096-b8", "sparse.mnn-block50",
         "lg.pairs-k1024-b32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "xfeat_bench/run.py", "--workload", cell,
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "xfeat_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
