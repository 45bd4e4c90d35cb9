"""Torch weights in and out of the port, against the JAX package, on the
CPU: the extractor's reference state dict (`import_torch_state_dict`,
`export_torch_state_dict`, `.pt` files and in-memory state dicts through
`XFeat`), `api.save_params`, and the LighterGlue matcher's kornia state
dict (`import_lighterglue_state_dict`). Mappings are exact (transposes and
a row permutation), so they are held under np.array_equal; forwards are
held at the tolerances of the existing parity tests, stated per test.

State dicts are saved as torch tensors: `torch.load(weights_only=True)`
refuses numpy arrays."""

import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerated_features_tpu import api as jax_api
from accelerated_features_tpu.models import lighterglue as jlg
from accelerated_features_tpu.models import params as jparams
from accelerated_features_tpu_torch import XFeat
from accelerated_features_tpu_torch.api import save_params
from accelerated_features_tpu_torch.models import lighterglue as lg
from accelerated_features_tpu_torch.models.params import (
    export_torch_state_dict, flatten_tree, fold_batchnorm,
    import_torch_state_dict, load_npz_tree, load_params, params_to_jax)

from torch_support import CKPT, LG_CKPT, ROOT



def _smoke():
    """`chip_smoke.py` as a module (for its matcher state-dict exporter)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _as_tensors(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def texture(seed, h, w):
    """Seeded gray uint8 texture: blocky noise at three scales."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for cell in (4, 8, 16):
        g = rng.uniform(0, 1, (h // cell + 2, w // cell + 2))
        img += np.kron(g, np.ones((cell, cell)))[:h, :w]
    return (img / 3 * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree():
    return load_npz_tree(CKPT)


@pytest.fixture(scope="module")
def pt_file(tree, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "xfeat.pt"
    torch.save(_as_tensors(export_torch_state_dict(tree)), path)
    return str(path)


# ---- the extractor ----------------------------------------------------------

def test_export_and_import_equal_the_jax_packages(tree):
    sd = export_torch_state_dict(tree)
    ref = jparams.export_torch_state_dict(tree)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].dtype == np.float32 and np.array_equal(sd[k], ref[k]), k
    got = import_torch_state_dict(_as_tensors(sd))
    _assert_trees_equal(got, jax.tree.map(np.asarray,
                                          jparams.import_torch_state_dict(
                                              _as_tensors(sd))))
    _assert_trees_equal(got, tree)  # a round trip gives the tree back


def test_export_raises_on_a_folded_tree(tree):
    with pytest.raises(ValueError, match="unfolded"):
        export_torch_state_dict(fold_batchnorm(tree))


@pytest.mark.parametrize("fold_bn", [True, False])
def test_load_params_reads_every_format_alike(tree, pt_file, fold_bn):
    """`.npz`, `.pt` and an in-memory state dict (tensor or numpy values)
    give bit-equal tensor trees."""
    ref = load_params(CKPT, fold_bn=fold_bn)
    sd = export_torch_state_dict(tree)
    for w in (pt_file, sd, _as_tensors(sd)):
        got = load_params(w, fold_bn=fold_bn)
        jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail(), got,
                     ref)


def test_xfeat_from_pt_state_dict_and_npz_agree(tree, pt_file):
    """detectAndCompute on the CPU gives torch.equal outputs for the three
    sources of the same weights."""
    im = texture(0, 96, 128)
    outs = [XFeat(weights=w, top_k=256, device="cpu").detectAndCompute(im)[0]
            for w in (pt_file, _as_tensors(export_torch_state_dict(tree)),
                      CKPT)]
    assert len(outs[0]["keypoints"]) > 50
    for o in outs[1:]:
        for k in o:
            assert torch.equal(o[k], outs[0][k]), k
    xf = XFeat(weights=None, top_k=256, device="cpu")
    xf.set_params(pt_file)
    for k, v in xf.detectAndCompute(im)[0].items():
        assert torch.equal(v, outs[0][k])


def test_jax_xfeat_from_the_same_pt_agrees(pt_file):
    """The JAX package's XFeat on the same `.pt` file, at the tolerances of
    `tests/test_torch_pipeline.py::test_detect_and_compute_matches_jax`:
    the same keypoints, scores within 1e-5, descriptors within 1e-4."""
    im = texture(0, 96, 128)
    ref = jax_api.XFeat(weights=pt_file, top_k=256).detectAndCompute(im)[0]
    got = {k: v.numpy() for k, v in XFeat(weights=pt_file, top_k=256,
                                           device="cpu")
           .detectAndCompute(im)[0].items()}
    assert len(ref["keypoints"]) > 50

    def by_position(d):
        order = np.lexsort((d["keypoints"][:, 0], d["keypoints"][:, 1]))
        return [d[k][order] for k in ("keypoints", "scores", "descriptors")]
    (rk, rs, rd), (gk, gs, gd) = by_position(ref), by_position(got)
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_allclose(gs, rs, atol=1e-5)
    np.testing.assert_allclose(gd, rd, atol=1e-4)


@pytest.mark.parametrize("source", ["port_tensors", "jax_numpy"])
def test_save_params_is_read_back_by_the_jax_loader(tree, tmp_path, source):
    """save_params of the port's tree (unfolded, tensors, through
    params_to_jax) or of the JAX-layout numpy tree -> the JAX package's
    load_params(fold_bn=False) gives the tree back; so does the port's."""
    params = load_params(CKPT, fold_bn=False) if source == "port_tensors" \
        else tree
    path = str(tmp_path / "w.npz")
    save_params(params, path)
    back = jax.tree.map(np.asarray, jax_api.load_params(path, fold_bn=False))
    _assert_trees_equal(back, tree)
    _assert_trees_equal(params_to_jax(load_params(path, fold_bn=False)),
                        tree)


# ---- the matcher ------------------------------------------------------------

def synthetic_lighterglue_sd(seed=3, dim=96, n_layers=6, scale=1.0):
    """A torch-layout LighterGlue state dict with kornia's key names before
    the reference's renames (the published checkpoint's layout): the
    builder of `tests/test_lighterglue.py::test_state_dict_import_roundtrip`
    with its depth and value scale as parameters."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    sd = {"input_proj.weight": normal(dim, 64),
          "input_proj.bias": normal(dim),
          "posenc.Wr.weight": normal(dim // 2, 2)}
    for i in range(n_layers):
        for blk, names in [
                (f"self_attn.{i}", [("Wqkv", (3 * dim, dim)),
                                    ("out_proj", (dim, dim))]),
                (f"cross_attn.{i}", [("to_qk", (dim, dim)),
                                     ("to_v", (dim, dim)),
                                     ("to_out", (dim, dim))])]:
            for nm, shape in names:
                sd[f"{blk}.{nm}.weight"] = normal(*shape)
                sd[f"{blk}.{nm}.bias"] = normal(shape[0])
            sd[f"{blk}.ffn.0.weight"] = normal(2 * dim, 2 * dim)
            sd[f"{blk}.ffn.0.bias"] = normal(2 * dim)
            sd[f"{blk}.ffn.1.weight"] = 1.0 + normal(2 * dim)
            sd[f"{blk}.ffn.1.bias"] = normal(2 * dim)
            sd[f"{blk}.ffn.3.weight"] = normal(dim, 2 * dim)
            sd[f"{blk}.ffn.3.bias"] = normal(dim)
        sd[f"log_assignment.{i}.matchability.weight"] = normal(1, dim)
        sd[f"log_assignment.{i}.matchability.bias"] = normal(1)
        sd[f"log_assignment.{i}.final_proj.weight"] = normal(dim, dim)
        sd[f"log_assignment.{i}.final_proj.bias"] = normal(dim)
        sd[f"token_confidence.{i}.token.0.weight"] = normal(1, dim)
        sd[f"token_confidence.{i}.token.0.bias"] = normal(1)
    return sd


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("layout", ["published", "renamed_prefixed",
                                     "no_bias"])
def test_import_lighterglue_state_dict_equals_the_jax_packages(heads,
                                                               layout):
    """Against JAX's import on the same state dict: the published names,
    the renamed ones with a `matcher.` prefix, and a Linear without its
    bias (zeros). Compared in the JAX layout (params_to_jax: the port's
    (out, in) weights transposed), under np.array_equal."""
    sd = synthetic_lighterglue_sd()
    if layout == "renamed_prefixed":
        renamed = {}
        for k, v in sd.items():
            for i in range(6):
                k = k.replace(f"self_attn.{i}.", f"transformers.{i}.self_attn.")
                k = k.replace(f"cross_attn.{i}.",
                              f"transformers.{i}.cross_attn.")
            renamed["matcher." + k] = v
        sd = renamed
    elif layout == "no_bias":
        del sd["self_attn.2.Wqkv.bias"], sd["cross_attn.4.to_v.bias"]
    conf = {**lg.DEFAULT_CONF, "num_heads": heads}
    jconf = {**jlg.DEFAULT_CONF, "num_heads": heads}
    got = lg.import_lighterglue_state_dict(_as_tensors(sd), conf)
    ref = jlg.import_lighterglue_state_dict(sd, jconf)
    assert got["layers"][0]["self"]["qkv"]["w"].shape == (3 * 96, 96)
    _assert_trees_equal(params_to_jax(got), _jax_tree(ref))


def test_lighterglue_forward_on_imported_trees_agrees_with_jax():
    """Two layers, 96 wide, two heads, a synthetic state dict at a scale
    that keeps activations O(1), imported by each package and run by each
    forward on M=48, N=40 with ragged masks: log_assignment within 1e-4
    where finite (rtol 1e-6) and -inf in the same places, matches0 equal
    on real rows, mscores0 within 1e-5 (the tolerances of
    `tests/test_torch_lighterglue.py::test_lighterglue_forward_matches_
    jax`)."""
    sd = synthetic_lighterglue_sd(seed=5, n_layers=2, scale=0.08)
    conf = {**lg.DEFAULT_CONF, "n_layers": 2, "num_heads": 2}
    jconf = {**jlg.DEFAULT_CONF, "n_layers": 2, "num_heads": 2}
    tp = lg.import_lighterglue_state_dict(_as_tensors(sd), conf)
    jp = jlg.import_lighterglue_state_dict(sd, jconf)
    rng = np.random.default_rng(6)
    m, n = 48, 40
    k0 = rng.uniform(0, [800, 608], (2, m, 2)).astype(np.float32)
    d0 = rng.normal(size=(2, m, 64)).astype(np.float32)
    perm = rng.permutation(m)[:n]
    k1 = (k0[:, perm] + rng.normal(size=(2, n, 2)) * 2).astype(np.float32)
    d1 = (d0[:, perm] + 0.2 * rng.normal(size=(2, n, 64))).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    size = np.tile(np.array([[800, 608]], np.float32), (2, 1))
    mask0 = np.arange(m)[None] < np.array([48, 31])[:, None]
    mask1 = np.arange(n)[None] < np.array([33, 40])[:, None]
    inputs = (k0, k1, d0, d1, size, size, mask0, mask1)
    kw = dict(heads=2, width_confidence=-1.0)
    ref = jax.jit(functools.partial(jlg.lighterglue_forward, **kw))(
        jp, *map(jnp.asarray, inputs))
    with torch.inference_mode():
        got = lg.lighterglue_forward(tp, *map(torch.from_numpy, inputs),
                                     **kw)
    ra, ga = np.asarray(ref["log_assignment"]), got["log_assignment"].numpy()
    np.testing.assert_array_equal(np.isneginf(ga), np.isneginf(ra))
    fin = np.isfinite(ra)
    np.testing.assert_allclose(ga[fin], ra[fin], atol=1e-4, rtol=1e-6)
    r0, g0 = np.asarray(ref["matches0"]), got["matches0"].numpy()
    np.testing.assert_array_equal(g0[mask0], r0[mask0])
    np.testing.assert_allclose(got["mscores0"].numpy(),
                               np.asarray(ref["mscores0"]), atol=1e-5)
    assert (g0[mask0] >= 0).sum() > 10


def test_smoke_exporter_round_trips_the_committed_matcher(tmp_path):
    """chip_smoke's inverse of `_qkv_row_perm` turns the committed matcher
    into a kornia state dict that both packages' imports read back to the
    same tree, and `LighterGlue` from that `.pt`, from the in-memory state
    dict and from the `.npz` holds bit-equal weights."""
    tree = load_npz_tree(LG_CKPT)
    sd = _smoke().lighterglue_state_dict(tree, lg.DEFAULT_CONF)
    assert "self_attn.0.Wqkv.weight" in sd
    _assert_trees_equal(
        params_to_jax(lg.import_lighterglue_state_dict(sd, lg.DEFAULT_CONF)),
        tree)
    _assert_trees_equal(
        _jax_tree(jlg.import_lighterglue_state_dict(sd, jlg.DEFAULT_CONF)),
        tree)
    path = str(tmp_path / "lg.pt")
    torch.save(_as_tensors(sd), path)
    ref = lg.LighterGlue(LG_CKPT, "cpu").params
    for w in (path, _as_tensors(sd)):
        got = lg.LighterGlue(w, "cpu").params
        jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail(), got,
                     ref)
    xf = XFeat(weights=None, device="cpu")
    jax.tree.map(lambda a, b: torch.equal(a, b) or pytest.fail(),
                 xf.set_lighterglue(path).params, ref)
