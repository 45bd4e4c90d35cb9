"""Weights of the XFeat backbone and the LighterGlue matcher for the
PyTorch port.

The port reads the same `.npz` files as the JAX package's
`api.load_params` (flat `a/b/0/w` keys; a full train state keeps its
weights under `params/` beside `opt_state/*`, which is ignored). The
tree keeps the JAX package's nesting:

  {'skip1': {'w', 'b'}, 'block1': [{'w', 'mean', 'var'}, ...], ...,
   'block_fusion' / 'heatmap_head' / 'keypoint_head': [..., {'w', 'b'}],
   'fine_matcher': [{'w', 'b', 'mean', 'var'} x4, {'w', 'b'}]}

BatchNorm is folded on the numpy tree exactly as the JAX package folds it,
then `params_from_jax` turns the tree into torch tensors in torch's own
layouts: conv weights HWIO -> OIHW, linear weights (in, out) -> (out, in);
`params_to_jax` turns them back.

`import_torch_state_dict` and `export_torch_state_dict` map the reference
PyTorch model's state dict (`.pt` files) to and from that numpy tree, as
the JAX package's functions of the same names do.

`init_xfeat_params` draws a fresh tree in that layout with the JAX
package's shapes and U(-b, b) bounds (torch's default kaiming-uniform
scheme), from a `torch.Generator`: the values differ from `jax.random`'s.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

BN_EPS = 1e-5  # torch BatchNorm default eps

BLOCK_NAMES = ["block1", "block2", "block3", "block4", "block5",
               "block_fusion", "heatmap_head", "keypoint_head"]

# kernel size and (in, out) channels of each BatchNorm conv, and the final
# plain conv with bias of three blocks (the JAX package's
# `models/backbone.py` plans)
BLOCK_CONVS: Dict[str, List[Tuple[int, int, int]]] = {
    "block1": [(3, 1, 4), (3, 4, 8), (3, 8, 8), (3, 8, 24)],
    "block2": [(3, 24, 24), (3, 24, 24)],
    "block3": [(3, 24, 64), (3, 64, 64), (1, 64, 64)],
    "block4": [(3, 64, 64), (3, 64, 64), (3, 64, 64)],
    "block5": [(3, 64, 128), (3, 128, 128), (3, 128, 128), (1, 128, 64)],
    "block_fusion": [(3, 64, 64), (3, 64, 64)],
    "heatmap_head": [(1, 64, 64), (1, 64, 64)],
    "keypoint_head": [(1, 64, 64), (1, 64, 64), (1, 64, 64)],
}
FINAL_CONVS = {"block_fusion": (64, 64), "heatmap_head": (64, 1),
               "keypoint_head": (64, 65)}
FINE_MATCHER_DIMS = [(128, 512), (512, 512), (512, 512), (512, 512),
                     (512, 64)]


def _uniform(gen: torch.Generator, shape, fan_in: int) -> np.ndarray:
    """U(-b, b) with b = 1/sqrt(fan_in): torch's default init of conv and
    linear weights (kaiming_uniform with a = sqrt(5)) and of biases."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * bound).numpy()


def init_xfeat_params(generator: Optional[torch.Generator] = None
                      ) -> Dict[str, Any]:
    """A fresh extractor tree in the JAX layout (numpy float32, conv HWIO,
    linear (in, out), BatchNorm running stats 0 and 1), drawn from
    `generator` (seed 0 when none is given)."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)

    def conv(k, cin, cout):
        return _uniform(gen, (k, k, cin, cout), cin * k * k)

    def stats(c):
        return {"mean": np.zeros((c,), np.float32),
                "var": np.ones((c,), np.float32)}

    params: Dict[str, Any] = {"skip1": {"w": conv(1, 1, 24),
                                        "b": _uniform(gen, (24,), 1)}}
    for name in BLOCK_NAMES:
        layers = [{"w": conv(k, cin, cout), **stats(cout)}
                  for k, cin, cout in BLOCK_CONVS[name]]
        if name in FINAL_CONVS:
            cin, cout = FINAL_CONVS[name]
            layers.append({"w": conv(1, cin, cout),
                           "b": _uniform(gen, (cout,), cin)})
        params[name] = layers
    mlp = []
    for i, (din, dout) in enumerate(FINE_MATCHER_DIMS):
        layer = {"w": _uniform(gen, (din, dout), din),
                 "b": _uniform(gen, (dout,), din)}
        if i < len(FINE_MATCHER_DIMS) - 1:
            layer.update(stats(dout))
        mlp.append(layer)
    params["fine_matcher"] = mlp
    return params


def count_params(params: Any) -> int:
    """Number of scalars in a parameter tree (numpy or torch leaves)."""
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(params.shape))


def _unflatten(flat: Mapping[str, Any]):
    """{'a/b/0/w': v} -> nested dicts, with all-digit keys turned into
    lists (same rule as the JAX package's loader)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """The inverse of `_unflatten`: nested dicts and lists -> {'a/b/0/w':
    leaf}, the key layout of the JAX package's `.npz` files."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}/"))
    return out


def load_npz_tree(path: str) -> Dict[str, Any]:
    """Read an extractor `.npz` into the JAX-layout numpy tree. A full
    train-state file contributes only its `params/` subtree."""
    with np.load(path, allow_pickle=False) as data:
        if any(k.startswith("params/") for k in data.keys()):
            flat = {k[len("params/"):]: data[k] for k in data.keys()
                    if k.startswith("params/")}
        else:
            flat = {k: data[k] for k in data.keys()}
    return _unflatten(flat)


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _conv_from_torch(sd: Mapping[str, Any], key: str) -> np.ndarray:
    return np.ascontiguousarray(_np32(sd[key]).transpose(2, 3, 1, 0))


# index of the plain conv with bias in three Sequentials of the reference
# model, and the fine matcher's (Linear, BatchNorm1d) indices
_FINAL_IDX = {"block_fusion": 2, "heatmap_head": 2, "keypoint_head": 3}
_FINE_IDX = [(0, 1), (3, 4), (6, 7), (9, 10)]
_FINE_LAST = 12


def import_torch_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference-format torch state dict (tensor or numpy values) -> the
    JAX-layout numpy tree, unfolded.

    Key layout of the reference model: BasicLayer i of Sequential `name`
    keeps its conv at `name.{i}.layer.0` and its BatchNorm running stats
    at `name.{i}.layer.1`; the final plain convs sit at their Sequential
    index (`_FINAL_IDX`); `skip1.1` is the skip conv; the fine matcher is
    Linear at 0, 3, 6, 9, 12 and BatchNorm1d at 1, 4, 7, 10."""
    params: Dict[str, Any] = {"skip1": {
        "w": _conv_from_torch(sd, "skip1.1.weight"),
        "b": _np32(sd["skip1.1.bias"])}}
    for name in BLOCK_NAMES:
        layers = []
        for i in range(len(BLOCK_CONVS[name])):
            layers.append({
                "w": _conv_from_torch(sd, f"{name}.{i}.layer.0.weight"),
                "mean": _np32(sd[f"{name}.{i}.layer.1.running_mean"]),
                "var": _np32(sd[f"{name}.{i}.layer.1.running_var"])})
        if name in _FINAL_IDX:
            i = _FINAL_IDX[name]
            layers.append({"w": _conv_from_torch(sd, f"{name}.{i}.weight"),
                           "b": _np32(sd[f"{name}.{i}.bias"])})
        params[name] = layers
    mlp = []
    for li, bi in _FINE_IDX:
        mlp.append({
            "w": np.ascontiguousarray(_np32(sd[f"fine_matcher.{li}.weight"]).T),
            "b": _np32(sd[f"fine_matcher.{li}.bias"]),
            "mean": _np32(sd[f"fine_matcher.{bi}.running_mean"]),
            "var": _np32(sd[f"fine_matcher.{bi}.running_var"])})
    mlp.append({
        "w": np.ascontiguousarray(
            _np32(sd[f"fine_matcher.{_FINE_LAST}.weight"]).T),
        "b": _np32(sd[f"fine_matcher.{_FINE_LAST}.bias"])})
    params["fine_matcher"] = mlp
    return params


def export_torch_state_dict(params: Mapping[str, Any]
                            ) -> Dict[str, np.ndarray]:
    """The inverse of `import_torch_state_dict`: a JAX-layout tree with
    its BatchNorm running stats -> the reference's state dict, numpy
    values. A folded tree has lost the stats and raises ValueError."""
    if "mean" not in params["block1"][0]:
        raise ValueError("export_torch_state_dict needs an unfolded tree "
                         "(BatchNorm running stats); load it with "
                         "fold_bn=False")

    def oihw(w):
        return np.ascontiguousarray(_np32(w).transpose(3, 2, 0, 1))

    sd: Dict[str, np.ndarray] = {"skip1.1.weight": oihw(params["skip1"]["w"]),
                                 "skip1.1.bias": _np32(params["skip1"]["b"])}
    for name in BLOCK_NAMES:
        for i in range(len(BLOCK_CONVS[name])):
            p = params[name][i]
            sd[f"{name}.{i}.layer.0.weight"] = oihw(p["w"])
            sd[f"{name}.{i}.layer.1.running_mean"] = _np32(p["mean"])
            sd[f"{name}.{i}.layer.1.running_var"] = _np32(p["var"])
        if name in _FINAL_IDX:
            p, i = params[name][-1], _FINAL_IDX[name]
            sd[f"{name}.{i}.weight"] = oihw(p["w"])
            sd[f"{name}.{i}.bias"] = _np32(p["b"])
    for p, (li, bi) in zip(params["fine_matcher"], _FINE_IDX):
        sd[f"fine_matcher.{li}.weight"] = np.ascontiguousarray(_np32(p["w"]).T)
        sd[f"fine_matcher.{li}.bias"] = _np32(p["b"])
        sd[f"fine_matcher.{bi}.running_mean"] = _np32(p["mean"])
        sd[f"fine_matcher.{bi}.running_var"] = _np32(p["var"])
    p = params["fine_matcher"][-1]
    sd[f"fine_matcher.{_FINE_LAST}.weight"] = np.ascontiguousarray(
        _np32(p["w"]).T)
    sd[f"fine_matcher.{_FINE_LAST}.bias"] = _np32(p["b"])
    return sd


def is_state_dict(weights: Any) -> bool:
    """A torch-style state dict: a mapping whose keys hold dots (the
    JAX-layout tree's keys never do)."""
    return isinstance(weights, Mapping) and any("." in str(k)
                                                for k in weights)


def read_torch_file(path: str) -> Dict[str, Any]:
    """A `.pt`/`.pth` state dict, tensors only (`weights_only=True`)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def is_torch_file(weights: Any) -> bool:
    return isinstance(weights, str) and weights.endswith((".pt", ".pth"))


def fold_batchnorm(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold affine-free BatchNorm running stats into the preceding conv or
    linear layer: y = (w*x - mean) / sqrt(var+eps) == (w*inv)*x - mean*inv.
    Works on the JAX-layout numpy tree with the JAX package's arithmetic,
    so both packages hold bit-identical folded weights."""
    def fold_layer(p):
        if "mean" not in p:
            return {k: np.asarray(v) for k, v in p.items()}
        inv = 1.0 / np.sqrt(np.asarray(p["var"]) + BN_EPS)
        w = np.asarray(p["w"])
        if w.ndim == 4:  # conv HWIO: scale output channels
            w = w * inv[None, None, None, :]
        else:  # linear (in, out)
            w = w * inv[None, :]
        b = -np.asarray(p["mean"]) * inv
        if "b" in p:  # linear with its own bias: fold it through BN too
            b = (np.asarray(p["b"]) - np.asarray(p["mean"])) * inv
        return {"w": w, "b": b}

    out: Dict[str, Any] = {"skip1": {k: np.asarray(v)
                                     for k, v in params["skip1"].items()}}
    for name in BLOCK_NAMES:
        out[name] = [fold_layer(p) for p in params[name]]
    if "fine_matcher" in params:
        out["fine_matcher"] = [fold_layer(p) for p in params["fine_matcher"]]
    return out


def _leaf_to_torch(key: str, v) -> torch.Tensor:
    a = np.asarray(v, dtype=np.float32)
    if key == "w" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif key == "w" and a.ndim == 2:
        a = a.T  # (in, out) -> torch Linear (out, in)
    return torch.tensor(a)


def params_from_jax(tree: Any) -> Any:
    """JAX-package parameter tree (numpy leaves, or anything np.asarray
    takes) -> the port's tree of float32 torch tensors on the CPU."""
    if isinstance(tree, Mapping):
        return {k: (_leaf_to_torch(k, v) if not isinstance(v, (Mapping, list,
                                                                tuple))
                    else params_from_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def _leaf_to_jax(key: str, t) -> np.ndarray:
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)
    if key == "w" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif key == "w" and a.ndim == 2:
        a = a.T  # (out, in) -> (in, out)
    return np.array(a, order="C")  # 0-d stays 0-d


def params_to_jax(tree: Any) -> Any:
    """The inverse of `params_from_jax`: the port's tree of tensors (any
    device) -> the JAX package's layout, numpy leaves (conv weights HWIO,
    linear weights (in, out)); BatchNorm stats and other leaves as they
    are."""
    if isinstance(tree, Mapping):
        return {k: (_leaf_to_jax(k, v) if not isinstance(v, (Mapping, list,
                                                              tuple))
                    else params_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    raise TypeError(f"unexpected parameter node {type(tree).__name__}")


def load_params(weights: Union[str, Mapping[str, Any], None],
                fold_bn: bool = True) -> Dict[str, Any]:
    """The extractor's weights in any format the JAX package's
    `api.load_params` reads -> the port's tensor tree (BatchNorm folded
    unless `fold_bn=False`):
      - an `.npz` path (a full train state contributes its `params/`);
      - a training checkpoint directory (its newest checkpoint);
      - a `.pt`/`.pth` path holding the reference's torch state dict;
      - an in-memory state dict: a mapping whose keys hold dots, with
        tensor or numpy values;
      - a JAX-layout numpy tree;
      - None: a random tree from `init_xfeat_params` (seed 0)."""
    if weights is None:
        tree = init_xfeat_params()
    elif isinstance(weights, str) and os.path.isdir(weights):
        from ..utils.checkpoint import latest_checkpoint
        path = latest_checkpoint(weights)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {weights}")
        tree = load_npz_tree(path)
    elif is_torch_file(weights):
        tree = import_torch_state_dict(read_torch_file(weights))
    elif isinstance(weights, str):
        tree = load_npz_tree(weights)
    elif is_state_dict(weights):
        tree = import_torch_state_dict(weights)
    else:
        tree = weights
    if fold_bn:
        tree = fold_batchnorm(tree)
    return params_from_jax(tree)


def load_lighterglue_params(weights: Union[str, Mapping[str, Any]]
                            ) -> Dict[str, Any]:
    """LighterGlue matcher `.npz` path (a full train state contributes its
    `params/` subtree), a training checkpoint directory (its newest
    checkpoint) or JAX-layout numpy tree -> the port's tensor tree.
    Linear weights become (out, in); `posenc_wr` keeps its (2, D/2) layout
    and `token_confidence` is carried across unread."""
    if isinstance(weights, str) and os.path.isdir(weights):
        from ..utils.checkpoint import latest_checkpoint
        path = latest_checkpoint(weights)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {weights}")
        weights = path
    tree = load_npz_tree(weights) if isinstance(weights, str) else weights
    return params_from_jax(tree)
