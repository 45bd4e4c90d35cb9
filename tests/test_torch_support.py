"""The thread rule of `tests/torch_support.py`: its pool size on four
environments, and the rule in force in this process and in the
subprocesses it starts."""

import os
import subprocess
import sys

import pytest
import torch

import torch_support


@pytest.mark.parametrize("env, cpus, want", [
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1),
    ({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4),
    ({}, 8, None),
    ({"PYTEST_XDIST_WORKER_COUNT": "6", "OMP_NUM_THREADS": "3"}, 8, None),
], ids=["6 workers on 8", "2 workers on 8", "no xdist", "OMP set"])
def test_pool_size(env, cpus, want):
    assert torch_support.pool_size(env, cpus) == want


def test_this_process_runs_the_rule():
    """Under xdist, unless OMP_NUM_THREADS came set, torch's pool is the
    worker's share of the CPUs, and a subprocess's torch gets the same;
    elsewhere the rule left torch's own pool."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if torch_support.POOL is None:
        assert workers is None or "OMP_NUM_THREADS" in os.environ
        return
    assert torch_support.POOL == max(1, os.cpu_count() // int(workers))
    assert torch.get_num_threads() == torch_support.POOL
    child = subprocess.run(
        [sys.executable, "-c",
         "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True, timeout=120)
    assert int(child.stdout) == torch_support.POOL
