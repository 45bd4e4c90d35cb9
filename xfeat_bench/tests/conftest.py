"""Tests of the benchmark harness. They run on the CPU at tiny sizes;
those marked `cuda` need an NVIDIA card and decide inside the test
whether one is present. Run from the repository root:

    python -m pytest xfeat_bench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips inside the test "
        "without one)")
