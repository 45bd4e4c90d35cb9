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
layouts: conv weights HWIO -> OIHW, linear weights (in, out) -> (out, in).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

BN_EPS = 1e-5  # torch BatchNorm default eps

BLOCK_NAMES = ["block1", "block2", "block3", "block4", "block5",
               "block_fusion", "heatmap_head", "keypoint_head"]


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


def load_params(weights: Union[str, Mapping[str, Any]],
                fold_bn: bool = True) -> Dict[str, Any]:
    """`.npz` path or JAX-layout numpy tree -> the port's tensor tree
    (BatchNorm folded unless `fold_bn=False`)."""
    tree = load_npz_tree(weights) if isinstance(weights, str) else weights
    if fold_bn:
        tree = fold_batchnorm(tree)
    return params_from_jax(tree)


def load_lighterglue_params(weights: Union[str, Mapping[str, Any]]
                            ) -> Dict[str, Any]:
    """LighterGlue matcher `.npz` path (a full train state contributes its
    `params/` subtree) or JAX-layout numpy tree -> the port's tensor tree.
    Linear weights become (out, in); `posenc_wr` keeps its (2, D/2) layout
    and `token_confidence` is carried across unread."""
    tree = load_npz_tree(weights) if isinstance(weights, str) else weights
    return params_from_jax(tree)
