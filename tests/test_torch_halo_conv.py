"""The port's halo-grouped conv (`experiments/halo_conv.py`) against the
JAX package's, on the CPU, at `tests/test_halo_conv.py`'s shapes.

Same seeded inputs through both: float32 within 1e-4 of JAX's halo conv
and of the direct conv (the JAX test's tolerance: float32 sums in
another order); bfloat16 within 3e-2 absolute and relative (the JAX
test's: bfloat16 products rounded in another order); the picked group
equal to JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu.experiments.halo_conv import \
    _pick_group as jax_pick_group
from accelerated_features_tpu.experiments.halo_conv import \
    conv2d_halo as jax_conv2d_halo
from accelerated_features_tpu_torch.experiments.halo_conv import (
    _pick_group, conv2d_halo, conv2d_nhwc)

SHAPES = [
    (1, 4, 1, 32, 64),     # stem conv1
    (4, 8, 2, 32, 64),     # stem conv2
    (8, 8, 1, 16, 48),     # stem conv3
    (8, 24, 2, 16, 48),    # stem conv4
    (24, 24, 1, 16, 32),   # block2
    (3, 5, 1, 24, 40),     # odd channel counts
]


@pytest.mark.parametrize("C,Cout,stride,H,W", SHAPES)
def test_halo_conv_matches_jax_f32(C, Cout, stride, H, W):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    w = rng.normal(size=(3, 3, C, Cout)).astype(np.float32)
    b = rng.normal(size=(Cout,)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, ww, bb: jax_conv2d_halo(
        a, ww, bb, stride))(x, w, b))
    got = conv2d_halo(*map(torch.from_numpy, (x, w, b)), stride=stride)
    direct = conv2d_nhwc(*map(torch.from_numpy, (x, w, b)), stride=stride)
    assert got.shape == (2, H // stride, W // stride, Cout)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-4)


@pytest.mark.parametrize("C,Cout,stride,H,W", SHAPES)
def test_halo_conv_matches_jax_bf16(C, Cout, stride, H, W):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    w = rng.normal(size=(3, 3, C, Cout)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, ww: jax_conv2d_halo(
        a, ww, None, stride))(jnp.asarray(x, jnp.bfloat16), w), np.float32)
    got = conv2d_halo(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(w), stride=stride)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


def test_pick_group_equals_jax():
    for wo, c, cout, s in [(320, 4, 8, 2), (640, 1, 4, 1), (80, 8, 24, 2),
                           (304, 8, 8, 1), (20, 3, 5, 1), (7, 24, 24, 1)]:
        assert _pick_group(wo, c, cout, s) == jax_pick_group(wo, c, cout, s)
