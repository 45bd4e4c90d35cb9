"""The names the JAX package exports exist in the port, and the functions
the port gained for them compute what JAX's do on the same seeded inputs.

Each JAX subpackage's `__all__` is walked; the stated exceptions are the
multi-device names (`parallel`, `train.make_sharded_train_step`), which
wait for the port's `torch.distributed` slice."""

import importlib
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerated_features_tpu as jpkg
import accelerated_features_tpu_torch as tpkg
from accelerated_features_tpu.models import backbone as jbb
from accelerated_features_tpu.ops import resize as jresize
from accelerated_features_tpu.ops import sample as jsample
from accelerated_features_tpu_torch import models as tmodels
from accelerated_features_tpu_torch import ops as tops

# multi-device code, ported with torch.distributed later
EXCEPTIONS = {"parallel": None, "train": {"make_sharded_train_step"}}

SUBPACKAGES = [""] + sorted(m.name for m in pkgutil.iter_modules(
    jpkg.__path__) if m.ispkg)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "root")
def test_port_has_every_jax_export(sub):
    jmod = importlib.import_module(
        "accelerated_features_tpu" + (f".{sub}" if sub else ""))
    names = getattr(jmod, "__all__", None)
    if names is None or (sub in EXCEPTIONS and EXCEPTIONS[sub] is None):
        return
    tmod = importlib.import_module(
        "accelerated_features_tpu_torch" + (f".{sub}" if sub else ""))
    skip = EXCEPTIONS.get(sub, set())
    missing = [n for n in names if n not in skip and not hasattr(tmod, n)]
    assert not missing, f"{tmod.__name__} lacks {missing}"
    assert set(names) - skip <= set(getattr(tmod, "__all__", names))


def test_root_exports_are_the_params_functions():
    from accelerated_features_tpu_torch.models import params
    assert tpkg.init_xfeat_params is params.init_xfeat_params
    assert tpkg.import_torch_state_dict is params.import_torch_state_dict
    assert tpkg.fold_batchnorm is params.fold_batchnorm


def _maps_and_points(seed, b=2, h=12, w=16, c=8, n=40, ref=(96, 128)):
    rng = np.random.default_rng(seed)
    maps = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # positions over and past the frame, so edge taps are exercised
    pos = np.stack([rng.uniform(-4, ref[1] + 3, (b, n)),
                    rng.uniform(-4, ref[0] + 3, (b, n))],
                   -1).astype(np.float32)
    return maps, pos, ref


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_interpolate_sparse2d_equals_jax(mode):
    maps, pos, (H, W) = _maps_and_points(1)
    ref = np.asarray(jsample.interpolate_sparse2d(jnp.asarray(maps),
                                                  jnp.asarray(pos), H, W,
                                                  mode))
    got = tops.interpolate_sparse2d(torch.from_numpy(maps),
                                    torch.from_numpy(pos), H, W, mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_sample_bicubic_matmul_equals_jax(dtype, tol):
    """float32 within 1e-5; bfloat16 rounds the map and the weights, so
    the two packages' roundings of the partial sums differ by up to 3e-2
    on values of size ~1."""
    maps, pos, ref_hw = _maps_and_points(2)
    ref = np.asarray(jsample.sample_bicubic_matmul(
        jnp.asarray(maps), jnp.asarray(pos), ref_hw, getattr(jnp, dtype)))
    got = tops.sample_bicubic_matmul(torch.from_numpy(maps),
                                     torch.from_numpy(pos), ref_hw,
                                     getattr(torch, dtype))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    plain = tops.sample_bicubic(torch.from_numpy(maps),
                                torch.from_numpy(pos), ref_hw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("out_hw", [(5, 7), (24, 40), (13, 9)])
def test_resize_nearest_torch_equals_jax(out_hw):
    x = np.random.default_rng(3).standard_normal((2, 12, 16, 3)) \
        .astype(np.float32)
    ref = np.asarray(jresize.resize_nearest_torch(jnp.asarray(x), out_hw))
    got = tops.resize_nearest_torch(torch.from_numpy(x), out_hw).numpy()
    assert np.array_equal(got, ref)
    nchw = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
        mode="nearest").permute(0, 2, 3, 1).numpy()
    assert np.array_equal(got, nchw)


def test_space_to_depth_and_upsample_bilinear_equal_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    assert np.array_equal(
        tmodels.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jbb.space_to_depth(jnp.asarray(x))))
    assert np.array_equal(
        tmodels.space_to_depth(torch.from_numpy(x), 4).numpy(),
        np.asarray(jbb.space_to_depth(jnp.asarray(x), 4)))
    # the two packages weigh the taps in another order: float32 rounding
    for out_hw in ((32, 48), (7, 11)):
        np.testing.assert_allclose(
            tmodels.upsample_bilinear(torch.from_numpy(x), out_hw).numpy(),
            np.asarray(jbb.upsample_bilinear(jnp.asarray(x), out_hw)),
            rtol=1e-5, atol=1e-5)


def test_xfeat_positional_parameters_are_jax_s():
    """`XFeat(w, 4096, 0.05, "bfloat16")` sets the compute dtype, as in
    JAX; the fifth is `fused_matching`; `device` is a keyword only."""
    xf = tpkg.XFeat(None, 4096, 0.05, "bfloat16", False, device="cpu")
    assert xf.compute_dtype == torch.bfloat16 and xf.top_k == 4096
    assert xf.fused_matching is False and xf.device.type == "cpu"
    with pytest.raises(TypeError):
        tpkg.XFeat(None, 4096, 0.05, "float32", None, "cpu")
