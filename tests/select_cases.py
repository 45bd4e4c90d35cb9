"""Adversarial rows for an exact top-k, shared by the CPU emulation of
kernel A's selection (`test_torch_select.py`) and the card tests
(`test_torch_cuda.py`). Imports neither JAX nor the JAX package."""

import numpy as np


def cases():
    """name -> ((B,N) float32 values, k). Adversarial for a radix select:
    ties everywhere, signed zeros, few positives among -1s, keys that
    straddle a histogram bin or share 22 top bits, ragged batches."""
    rng = np.random.default_rng(0)
    c = {}
    c["all equal"] = (np.full((2, 1000), 0.5, np.float32), 37)
    c["all equal k=N"] = (np.full((1, 1000), 0.5, np.float32), 1000)
    c["signed zeros"] = (rng.choice(np.float32([-1, -0.0, 0.0, 0.3]),
                                    (2, 3000)), 1500)
    c["k=1"] = (rng.normal(size=(2, 5000)).astype(np.float32), 1)
    c["k=N"] = (rng.normal(size=(2, 777)).astype(np.float32), 777)
    c["k>N"] = (rng.uniform(size=(2, 300)).astype(np.float32), 4096)
    few = np.full((2, 20000), -1.0, np.float32)
    few[0, rng.choice(20000, 50, replace=False)] = rng.uniform(0.05, 1, 50)
    few[1, rng.choice(20000, 3, replace=False)] = 0.0
    c["few positives among -1"] = (few, 4096)
    # keys on both sides of bin edges: powers of two and their neighbours
    edges = np.float32([2.0 ** e for e in range(-8, 1)])
    near = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                           np.nextafter(edges, np.float32(2))])
    c["bin edges"] = (rng.choice(near, (2, 4000)), 1000)
    # the same top 22 bits: only the last 10 tell them apart, with ties
    base = np.float32(0.3).view(np.int32) & ~np.int32(1023)
    low = rng.integers(0, 1024, (1, 6000)).astype(np.int32)
    c["last 10 bits"] = ((base + low).view(np.float32), 2500)
    ragged = np.full((3, 30000), -1.0, np.float32)
    for i, m in enumerate((10, 4096, 9000)):
        ragged[i, rng.choice(30000, m, replace=False)] = \
            rng.uniform(0.05, 1, m)
    c["B=3 ragged"] = (ragged, 4096)
    c["large k, global sort"] = (rng.normal(size=(1, 140000)).astype(
        np.float32), 135000)
    return c



CASES = cases()
